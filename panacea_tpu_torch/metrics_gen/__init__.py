"""Generation metrics of the port: FID and FVD (``fid.py``) over InceptionV3
(``inception.py``) and I3D (``i3d.py``) features, and the CLI (``eval.py``).

Counterpart of ``panacea_tpu/metrics_gen`` and the root
``eval_generation.py``. The towers keep the reference torch names
(torchvision's InceptionV3, pytorch-i3d), so their checkpoints load without a
converter; ``convert.inception_state_dict_from_jax`` and
``i3d_state_dict_from_jax`` carry the JAX package's weights for the tests.
"""
