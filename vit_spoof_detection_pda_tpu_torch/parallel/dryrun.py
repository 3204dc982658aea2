"""One training step over a (data, seq) mesh, as a check that the
port's data and sequence parallelism run (the DP and SP parts of the JAX
package's ``__graft_entry__.py::dryrun_multichip`` :112).

    python -m vit_spoof_detection_pda_tpu_torch.parallel.dryrun [ranks] [--device cpu]

spawns ``ranks`` processes (4 by default: data 2 x seq 2) joined in a
gloo group on a free localhost port; each builds the flagship family
scaled down (ViTAntiSpoof, D 256, depth 2, 4 heads, 32x32 faces, random
weights from one seed), takes its rows of one global batch and runs one
focal-loss step, on the card unless ``--device cpu`` asks for the CPU
(without a card and without that flag it exits before spawning).  It
asserts a finite loss equal on every rank, and that the attention went
through the sequence-parallel path: kernel 12 and kernel 13 launched on
the card, their plain versions on the CPU.
"""

from __future__ import annotations

import socket
import sys

import numpy as np
import torch


_COUNTED = ("attention_cp_f32", "attention_cp_bwd_f32", "attention_qkv",
            "attention_qkv_bwd_f32")


def free_port() -> int:
    """A free localhost TCP port for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(target, world: int, *args, timeout: float = 600.0) -> dict:
    """Run ``target(rank, world, *args, port, queue)`` in ``world`` spawned
    processes joined on one free localhost port.  Each rank puts ``(rank,
    report)`` on ``queue``, a report with an ``"error"`` key if the rank
    failed.  Returns the reports by rank and raises if any rank failed;
    every process is joined (or ended) before this returns."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, world, *args, port, q))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        reports = dict(q.get(timeout=timeout) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    errors = {r: v["error"] for r, v in reports.items() if "error" in v}
    if errors:
        raise AssertionError(f"ranks failed: {errors}")
    return reports


def _rank_main(rank: int, world: int, seq: int, device: str, port: int,
               out):
    import traceback

    import torch.distributed as dist

    from .mesh import init_multi_host

    try:
        init_multi_host("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
        out.put((rank, _rank_step(world, seq, device)))
    except BaseException:                       # noqa: BLE001 - reported
        out.put((rank, {"error": traceback.format_exc()}))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rank_step(world: int, seq: int, device: str) -> dict:
    import torch.distributed as dist

    from ..models.vit import ViTAntiSpoof
    from ..ops import attention as att
    from ..ops.losses import make_loss_fn
    from ..train.schedule import make_lr_schedule
    from ..train.state import create_train_state, make_optimizer
    from ..train.step import make_train_step
    from ..train.trainer import module_tree_apply
    from .mesh import make_seq_mesh, shard_batch

    mesh = make_seq_mesh(seq=seq, data=world // seq, device_type=device)
    torch.manual_seed(0)
    module = ViTAntiSpoof(embed_dim=256, depth=2, num_heads=4, hidden=64,
                          img_size=32, patch_size=16).to(device)
    state = create_train_state(
        module, make_optimizer(make_lr_schedule(1e-3, 10)), seed=0,
        apply_fn=module_tree_apply(module), device=device)
    rng = np.random.default_rng(0)
    n = 2 * world
    batch = {"image": rng.random((n, 32, 32, 3), dtype=np.float32),
             "label": np.arange(n) % 2}
    step = make_train_step(make_loss_fn("focal"), mesh=mesh)
    calls, launches = att._context["cp_calls"], dict(att.LAUNCHES)
    state, metrics = step(state, shard_batch(batch, mesh, device=device))
    loss = float(metrics["loss"])
    took = {"cp_calls": att._context["cp_calls"] - calls}
    if device == "cuda":
        # the f32 model's forms: kernels 12 and 13, kernels 8 and 4
        took.update({k: att.LAUNCHES[k] - launches[k] for k in _COUNTED})
    losses = [None] * world
    dist.all_gather_object(losses, loss)
    return {"loss": loss, "losses": losses, **took}


def dryrun_multichip(n_ranks: int = 4, *, seq: int = 2,
                     device: str = "cuda") -> dict:
    """Run the step on ``n_ranks`` processes (``seq`` ranks a sequence
    group), all on the card unless ``device="cpu"``; returns rank 0's
    report, after the asserts."""
    if n_ranks % seq:
        raise ValueError(f"{n_ranks} ranks not divisible by seq={seq}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the dry run runs on a CUDA card and none is "
                               "available; pass device='cpu' to run the "
                               "kernels' plain versions")
        # build before spawning: no two ranks run nvcc into one directory
        from ..ops import _build
        _build.build(("attention_cp", "attention_cp_bwd"))
    reports = run_ranks(_rank_main, n_ranks, seq, device)
    rep = reports[0]
    if not np.isfinite(rep["loss"]) or len(set(rep["losses"])) != 1:
        raise AssertionError(f"ranks disagree or diverged: {rep['losses']}")
    # one sequence-parallel dispatch per layer (depth 2) in the forward
    if any(r["cp_calls"] != 2 for r in reports.values()):
        raise AssertionError(f"the SP step fell back from the CP path: "
                             f"{reports}")
    if device == "cuda" and any(
            r["attention_cp_f32"] != 2 or r["attention_cp_bwd_f32"] != 2
            or r["attention_qkv"] or r["attention_qkv_bwd_f32"]
            for r in reports.values()):
        raise AssertionError(f"kernels 12 / 13 not launched as expected: "
                             f"{reports}")
    return rep


def main(argv=None) -> int:
    import argparse

    from ..cli.common import resolve_device

    parser = argparse.ArgumentParser(
        prog="python -m vit_spoof_detection_pda_tpu_torch.parallel.dryrun",
        description="one data x seq training step on spawned gloo ranks")
    parser.add_argument("ranks", nargs="?", type=int, default=4)
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="the card (default) or the kernels' plain "
                             "versions on the CPU")
    args = parser.parse_args(argv)
    device = resolve_device(parser, args)
    n = args.ranks
    rep = dryrun_multichip(n, device=device)
    print(f"dryrun_multichip({n}): data {n // 2} x seq 2 on {device}: "
          f"loss={rep['loss']:.4f}, sequence-parallel dispatches "
          f"{rep['cp_calls']} a step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
