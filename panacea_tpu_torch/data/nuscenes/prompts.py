"""Prompt construction.

The 20 scene templates are functional constants of the trained checkpoint —
the text conditioning distribution Panacea was trained on
(nuscenes_datasets_video.py:91-112, 276-284) — reproduced for parity the same
way hyperparameters are.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

PROMPT_TEMPLATES = [
    "This portrays an urban road panorama, composed from a jointure of six encompassing viewpoint images.  The whole scene contains {} targets, comprising ",
    "The encompassed illustration discloses an urban roadway scenery pieced together from six wide-angle snapshots.  The entire depiction embraces {} objectives, inclusive of ",
    "We observe an urban street spectacle, arranged from the composition of six all-encompassing perspective graphics. The collective stage comprises {} features, including ",
    "We're presented with an urban route visualization, amalgamated from six encompassing angle images. The entire layout thus, contains {} targets, comprising ",
    "This reveals a city thoroughfare tableau, composed of a fusion of six panoramic imagery.  This comprehensive depiction incorporates {} goals, including ",
    "It embodies an urban lane portrait, incontrarintegrated from six encompassing angle snips. The whole scene accommodates {} subject matters, including ",
    "This unfolds an urban road sight, consolidated from partials of six encompassing viewpoint snapshots. The integrated framework invites {} subjects, incorporating ",
    "Within, we find an urban theme combining components from six sweeping viewpoint captures. The all-inclusive image contains {} targets including ",
    "This rendering is an urban avenue spectacle, masterfully stiched from six encompassing viewpoint visuals. The inclusive display holds {} subjects, embracing ",
    "Embodied in an urban route tableau, synthesized from six surround-view visuals. The unfolding tableau harbors {} subjects, comprising ",
    "This captures a metropolitan road scenario, meticulously constructed from a montage of six surrounding viewpoint images. The entirety of the scene contains {} targets, inclusive of ",
    "Here is an illustration of a cosmopolitan street view, artfully crafted from six peripheral vantage point pictures. The full layout accommodates {} objectives, including ",
    "Presented is a city locale framework, creatively assembled using six encompassing angular perspectives. The gathered tableau incorporates {} targets, encompassing ",
    "What you see is a city street setting, ingeniously put together from six panoramic snapshots. This amalgamated scene houses {} objectives, inclusive of ",
    "We have an urban street decor, deftly stitched together utilizing six peripheral perspective images. The comprehensive scene involves {} objects, embodying ",
    "This presents an urban road environment, constructed with the fusion of six surrounding perspective images. The whole scene contains {} targets, including ",
    "Here we have a city road tableau, synthesized from an amalgamation of six surrounding view images. Overall, the scene incorporates {} objects of interest, including ",
    "We're presented with an urban thoroughfare scene, born of the merging of six circumambient visual representations. The panorama contains {} landmarks, including ",
    "This is a representation of a city street setting, composing of six pictures portraying different angles. The complete landscape includes {} principal targets, including ",
    "Displayed is a metropolitan roadway scenario, composed of six peripheral perspective images combined. The holistic scenario encloses {} prime objectives, embodying ",
]


def generate_prompt(
    labels: Sequence[int],
    class_names: Sequence[str],
    rng: Optional[random.Random] = None,
) -> str:
    """Template + object-class listing (nuscenes_datasets_video.py:276-284)."""
    rng = rng or random
    names = [class_names[int(i)] for i in labels]
    template = rng.choice(PROMPT_TEMPLATES)
    return template.format(str(len(names))) + ", ".join(names)
