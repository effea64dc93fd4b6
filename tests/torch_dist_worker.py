"""One rank of the data-parallel tests (tests/test_torch_parallel*.py):
``scripts/dist_rank.py`` with two test hooks, each set by a flag given
before dist_rank's own arguments.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        tests/torch_dist_worker.py [--uneven_gt] [--record_saves DIR] <dist_rank args>

``--uneven_gt`` keeps 1 + key % 3 of each training window's boxes (key =
the window's key frame), so that windows differ in their matched counts and
a loss whose avg factor is not averaged over the ranks shows in the step.
``--record_saves DIR`` writes the paths of the files every ``torch.save``
of this rank wrote to ``DIR/saves_rank{R}.json``. ``--view_shard_checks
DIR`` first runs ``tests/torch_view_shard_checks.py`` in the process group
(on the grid of the CLI's ``--view_shard``) and writes its results to DIR;
``--ring_checks DIR`` runs its ring cases alone, without a CLI.
``--fsdp_checks DIR`` runs ``tests/torch_fsdp_checks.py`` in the process
group and nothing else. ``--train_grid_checks DIR`` first runs ``tests/torch_train_grid_checks.py``
in the process group and writes its results to DIR; without dist_rank
arguments after it, nothing else runs. ``--then_resume`` runs the training
CLI again in the same group after dist_rank's run, on the same arguments
resumed from ``<--ckpt_dir>/iter_1`` (``torch_train_grid_checks.resume``,
results in the checks' DIR).
"""

import json
import os
import runpy
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    args = sys.argv[1:]
    uneven = "--uneven_gt" in args
    if uneven:
        args.remove("--uneven_gt")
    record = None
    if "--record_saves" in args:
        i = args.index("--record_saves")
        record = args[i + 1]
        del args[i:i + 2]
    checks = ring = grid = fsdp_dir = None
    then_resume = "--then_resume" in args
    if then_resume:
        args.remove("--then_resume")
    if "--train_grid_checks" in args:
        i = args.index("--train_grid_checks")
        grid = args[i + 1]
        del args[i:i + 2]
    if "--fsdp_checks" in args:
        i = args.index("--fsdp_checks")
        fsdp_dir = args[i + 1]
        del args[i:i + 2]
    if "--view_shard_checks" in args:
        i = args.index("--view_shard_checks")
        checks = args[i + 1]
        del args[i:i + 2]
    if "--ring_checks" in args:
        i = args.index("--ring_checks")
        ring = args[i + 1]
        del args[i:i + 2]

    import torch

    if fsdp_dir:
        import torch.distributed as dist
        import torch_fsdp_checks

        from panacea_tpu_torch.parallel import mesh

        mesh.maybe_init_distributed("cpu")
        torch_fsdp_checks.run(fsdp_dir)
        dist.destroy_process_group()
        return
    if checks or ring or grid:
        import torch.distributed as dist
        import torch_train_grid_checks
        import torch_view_shard_checks

        from panacea_tpu_torch.parallel import mesh

        mesh.maybe_init_distributed("cpu")
    if ring:
        torch_view_shard_checks.run_ring(ring)
        dist.destroy_process_group()
        return
    if grid:
        torch_train_grid_checks.run(grid)
        if not args:
            dist.destroy_process_group()
            return
    if checks:
        torch_view_shard_checks.run(checks, int(args[args.index("--view_shard") + 1]))

    if uneven:
        from panacea_tpu_torch.perception.train_dataset import PerceptionTrainDataset

        window_with_gt = PerceptionTrainDataset.window_with_gt

        def fewer_boxes(self, key_idx, *a, **kw):
            item = window_with_gt(self, key_idx, *a, **kw)
            if item is None:
                return None
            boxes, labels = item[1].copy(), item[2].copy()
            keep = 1 + key_idx % 3
            boxes[:, keep:] = 0.0
            labels[:, keep:] = -1
            return (item[0], boxes, labels) + tuple(item[3:])

        PerceptionTrainDataset.window_with_gt = fewer_boxes
    saves = []
    if record:
        save = torch.save

        def recorded_save(obj, f, *a, **kw):
            if isinstance(f, (str, os.PathLike)):     # files, not the collectives' buffers
                saves.append(os.path.abspath(f))
            return save(obj, f, *a, **kw)

        torch.save = recorded_save
    sys.argv = [os.path.join(ROOT, "scripts", "dist_rank.py")] + args
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    except SystemExit as e:
        if e.code:
            raise
    if then_resume:
        cli = args[args.index("--") + 1:]
        ckpt = cli[cli.index("--ckpt_dir") + 1]
        torch_train_grid_checks.resume(grid, cli + ["--resume", os.path.join(ckpt, "iter_1"),
                                                    "--ckpt_every", "0", "--ckpt_dir",
                                                    os.path.join(grid, "resumed")])
    if checks or grid:
        dist.destroy_process_group()
    if record:
        os.makedirs(record, exist_ok=True)
        rank = int(os.environ.get("RANK", "0"))
        with open(os.path.join(record, f"saves_rank{rank}.json"), "w") as f:
            json.dump(saves, f)


if __name__ == "__main__":
    main()
