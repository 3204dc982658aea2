"""One rank of tests/test_torch_sequence_parallel.py's multi-process runs
(not a test module: the test starts one process per rank).

    python tests/torch_sp_worker.py <job> <rank> <world> <port> <dir>

Imports torch and the port, never JAX.  Joins a gloo group on
``tcp://127.0.0.1:<port>``, reads its inputs from ``<dir>`` (``.npz``
files the test wrote from numpy seeds and the JAX parameter tree) and
writes ``<dir>/<job>_rank<r>.npz``:

- ``fwd4``: the sequence-parallel forward at (data, seq) = (2, 2) and
  (1, 4), and one focal-loss step at (2, 2) with dropout 0.1 and 0;
- ``fwd2``: the forward at (1, 2); ``run_inference`` at data 2; three
  two-rank ``Trainer.fit`` runs at data 2 (uninterrupted, preempted at
  epoch 1 batch 1 with a checkpoint, resumed from it).
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from vit_spoof_detection_pda_tpu_torch.config import Config  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.models.convert import (  # noqa: E402
    load_jax_params)
from vit_spoof_detection_pda_tpu_torch.models.vit import ViTAntiSpoof  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.ops import attention as att  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.ops.losses import make_loss_fn  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.parallel import mesh as pm  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.train import schedule, state  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.train.step import make_train_step  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.train.trainer import (  # noqa: E402
    Trainer, module_tree_apply)

GEOM = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, hidden=32,
            img_size=32)
OPT = dict(weight_decay=0.05, beta1=0.9, beta2=0.999, max_grad_norm=1.0)
TRAIN_CFG = {"data.img_size": 32, "telemetry.log_interval": 100,
             "model.compute_dtype": "float32", "optim.learning_rate": 1e-3,
             "optim.warmup_epochs": 0, "optim.num_epochs": 2,
             "model.fused_train_forward": False}


def tree_from_npz(path):
    """The nested parameter dict a flat ``a/b/c`` npz holds."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().cpu().numpy()
    return out


def module(params, dropout=0.1):
    return load_jax_params(ViTAntiSpoof(dropout=dropout, **GEOM), params)


def forward(params, x, mesh):
    m = module(params).eval()
    rows = pm.shard_batch({"x": x}, mesh)["x"]
    calls = att._context["cp_calls"]
    with torch.no_grad(), att.attention_sharding(mesh):
        logits = m(rows)
    return logits.numpy(), att._context["cp_calls"] - calls


def step(params, batch, mesh, dropout):
    m = module(params, dropout)
    st = state.create_train_state(
        m, state.make_optimizer(schedule.make_lr_schedule(3e-4, 100), **OPT),
        seed=0, variables={"params": params},
        apply_fn=module_tree_apply(m), device="cpu")
    fn = make_train_step(make_loss_fn("focal"), mesh=mesh)
    calls = att._context["cp_calls"]
    st, metrics = fn(st, pm.shard_batch(batch, mesh))
    out = {f"p/{k}": v for k, v in flat(st.params).items()}
    out["loss"] = float(metrics["loss"])
    out["grad_norm"] = float(metrics["grad_norm"])
    out["cp_calls"] = att._context["cp_calls"] - calls
    return out


class Log:
    def __init__(self):
        self.records = []

    def log(self, record, step=None):
        self.records.append(dict(record))


def trainer_runs(params, d, mesh, rank):
    """Uninterrupted, preempted and resumed two-rank fits on this rank's
    rows of the global batches (the test's single-process run takes the
    whole of each)."""
    from vit_spoof_detection_pda_tpu_torch.utils.checkpoint import (
        CheckpointManager)

    images, labels = d["train_x"], d["train_y"]
    val_x, val_y = d["val_x"], d["val_y"]
    n_data, bs = 2, int(d["bs"])
    per, vper = bs // n_data, len(val_x) // n_data

    def feeds(preempt=None):
        def train_batches(epoch, skip=0):
            idx = np.random.default_rng(epoch).permutation(len(images))
            for bi, i in enumerate(range(0, len(images) - bs + 1, bs)):
                if bi < skip:
                    continue
                if preempt is not None and (epoch, bi) == preempt[0] and \
                        rank == 0:
                    preempt[1][0].request_preemption()   # rank 0 only
                j = idx[i:i + bs][rank * per:(rank + 1) * per]
                yield {"image": images[j], "label": labels[j]}

        def val_batches():
            lo = rank * vper
            yield {"image": val_x[lo:lo + vper], "label": val_y[lo:lo + vper]}

        return train_batches, val_batches

    def trainer(log, ckpt=None, preempt=None):
        tb, vb = feeds(preempt)
        cfg = Config().with_overrides({**TRAIN_CFG, "model.dropout": 0.1})
        return Trainer(cfg, module(params), train_batches=tb,
                       val_batches=vb, steps_per_epoch=len(images) // bs,
                       variables={"params": params}, device="cpu",
                       logger=log, checkpoints=ckpt, mesh=mesh)

    out = {}
    log = Log()
    full = trainer(log, CheckpointManager(os.path.join(d["dir"], "full")))
    full.fit()
    epochs = [r for r in log.records if "train/epoch" in r]
    for key in ("train/loss", "val/loss", "val/optimal_threshold",
                "val/auc", "val/f1"):
        out[f"fit/{key}"] = np.array([r[key] for r in epochs])
    mgr = CheckpointManager(os.path.join(d["dir"], "preempted"))
    ref = [None]
    t_a = trainer(Log(), mgr, preempt=((1, 1), ref))
    ref[0] = t_a
    out["preempted"] = bool(t_a.fit().get("preempted"))
    step_at = mgr.latest_step()
    spe = len(images) // bs
    t_b = trainer(Log())
    t_b.state = mgr.restore(t_b.state)
    t_b.fit(start_epoch=step_at // spe, start_batch=step_at % spe)
    out["resume_step"] = step_at
    out["resume_bit_equal"] = all(
        torch.equal(a, b) for a, b in zip(full.state.leaves(),
                                          t_b.state.leaves()))
    out["full_step"] = int(full.state.step)
    out.update({f"full/{k}": v for k, v in flat(full.state.params).items()})
    return out


def main():
    job, rank, world, port, d = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    pm.init_multi_host("gloo", init_method=f"tcp://127.0.0.1:{port}",
                       rank=rank, world_size=world)
    try:
        params = tree_from_npz(os.path.join(d, "params.npz"))
        data = dict(np.load(os.path.join(d, "data.npz")))
        data["dir"] = d
        x = torch.from_numpy(data["x"])
        out = {}
        if job == "fwd4":
            for dp, sp in ((2, 2), (1, 4)):
                mesh = pm.make_seq_mesh(seq=sp, data=dp, device_type="cpu")
                out[f"fwd_{dp}x{sp}"], out[f"calls_{dp}x{sp}"] = forward(
                    params, x, mesh)
            mesh = pm.make_seq_mesh(seq=2, data=2, device_type="cpu")
            batch = {"image": data["x"], "label": data["y"]}
            for drop in (0.1, 0.0):
                res = step(params, batch, mesh, drop)
                out.update({f"step{drop}/{k}": v for k, v in res.items()})
        else:
            mesh = pm.make_seq_mesh(seq=2, data=1, device_type="cpu")
            out["fwd_1x2"], out["calls_1x2"] = forward(params, x, mesh)
            from vit_spoof_detection_pda_tpu_torch.data.manifest import Record
            from vit_spoof_detection_pda_tpu_torch.eval.runner import (
                run_inference)
            dmesh = pm.make_mesh(data=2, model=1, device_type="cpu")
            recs = [Record(path=os.path.join(d, f"face{i}.png"),
                           label=int(data["rec_y"][i]))
                    for i in range(len(data["rec_y"]))]
            m = module(params).eval()
            res = run_inference(m, recs, batch_size=4, img_size=32,
                                num_workers=1, mesh=dmesh)
            out.update({f"score/{k}": v for k, v in res.items()})
            out.update(trainer_runs(params, data, dmesh, rank))
        np.savez(os.path.join(d, f"{job}_rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
