"""One rank of the model-parallel tests' multi-process runs (not a test
module: tests/test_torch_tensor_parallel.py, test_torch_pipeline.py and
test_torch_sharding_trainer.py start one process per rank).

    python tests/torch_mp_worker.py <job> <rank> <world> <port> <dir>

Imports torch and the port, never JAX.  Joins a gloo group on
``tcp://127.0.0.1:<port>``, reads its inputs from ``<dir>`` (``.npz``
files the test wrote from numpy seeds and JAX parameter trees) and writes
``<dir>/<job>_rank<r>.npz``.  Jobs:

- ``tp``: Megatron tensor parallelism: forwards, gradients and one AdamW
  step; FSDP's layout and step (2 ranks: (data, model) = (1, 2), data 2;
  4 ranks: (2, 2), (1, 4), data 4);
- ``pp``: the GPipe schedule: forwards at (data, pipe, microbatches),
  gradients with and without remat, one step; DP x TP x PP (4 ranks);
- ``trainer``: ``Trainer.fit`` under each layout, a pipeline run's
  checkpoint and its resume.

Every whole leaf comes back gathered from the ranks' slices
(``ParamLayout.gather``), so the test compares whole trees.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from vit_spoof_detection_pda_tpu_torch.config import Config  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.models.convert import (  # noqa: E402
    load_jax_params)
from vit_spoof_detection_pda_tpu_torch.models.vit import ViTAntiSpoof  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.ops import attention as att  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.ops.losses import make_loss_fn  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.parallel import mesh as pm  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.parallel import pipeline as pp  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.parallel.collectives import (  # noqa: E402
    all_gather_rows, gather_rows)
from vit_spoof_detection_pda_tpu_torch.train import schedule, state  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.train.step import (  # noqa: E402
    make_train_step, reduce_gradients)
from vit_spoof_detection_pda_tpu_torch.train.trainer import (  # noqa: E402
    Trainer, module_tree_apply)

# the JAX pipeline tests' model (tests/test_pipeline.py:17): T = 5 tokens
GEOM = dict(patch_size=16, embed_dim=64, depth=4, num_heads=4, hidden=32,
            img_size=32)
# three heads, which no model axis of 2 or 4 divides
GEOM3 = dict(GEOM, embed_dim=66, num_heads=3)
LR = 3e-4
SGD_LR = 0.1
OPT = dict(weight_decay=0.05, beta1=0.9, beta2=0.999, max_grad_norm=1.0)
FSDP_MIN = 1024
TRAIN_CFG = {"data.img_size": 32, "telemetry.log_interval": 100,
             "model.compute_dtype": "float32", "optim.learning_rate": 1e-3,
             "optim.warmup_epochs": 0, "optim.num_epochs": 2,
             "model.fused_train_forward": False, "model.dropout": 0.0}


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


def module(params, geom=GEOM, dropout=0.0):
    return load_jax_params(ViTAntiSpoof(dropout=dropout, **geom), params)


def torch_tree(params):
    return {k: torch_tree(v) if isinstance(v, dict)
            else torch.as_tensor(np.asarray(v)) for k, v in params.items()}


class SGD:
    """Plain SGD in the optimizer's interface: the parity steps compare
    parameters after one step, and SGD keeps that a comparison of
    gradients, as JAX's tests/test_parallel.py:80 does (Adam's first step
    moves a near-zero gradient's element by about lr on its rounding
    noise)."""

    def __init__(self, lr: float = SGD_LR):
        self.lr = lr

    def init(self, params):
        return {"count": 0, "mu": None, "nu": None, "ema": None,
                "acc": None, "mini_step": 0}

    @torch.no_grad()
    def update(self, grads, opt_state, params, norm_fn=None):
        torch._foreach_add_(params, [g.float() for g in grads],
                            alpha=-self.lr)
        opt_state["count"] += 1
        return True


def new_state(m, params, layout=None, apply_fn=None, tx=None):
    return state.create_train_state(
        m, tx or state.make_optimizer(schedule.make_lr_schedule(LR, 100),
                                      **OPT),
        seed=0, variables={"params": params},
        apply_fn=apply_fn or module_tree_apply(m), device="cpu",
        layout=layout)


def full_params(st):
    return flat(st.full().params)


def mesh_grads(st, images, labels, mesh):
    """The global-batch CE gradient of the state's forward on this rank's
    rows (the train step's reductions), gathered whole."""
    rows = pm.shard_batch({"x": images, "y": labels}, mesh)
    leaves = st.leaves()
    with att.attention_sharding(mesh):
        logits = st.apply_fn({"params": st.params}, rows["x"])
    group = mesh.get_group(pm.DATA_AXIS)
    logits = gather_rows(logits, group)
    y = all_gather_rows(rows["y"], group)
    loss = F.cross_entropy(logits, y)
    grads = reduce_gradients(list(torch.autograd.grad(loss, leaves)), mesh,
                             st.layout)
    full = st.layout.gather_list(grads) if st.layout else grads
    return flat(state.tree_unflatten(st.paths, full))


def one_step(st, batch, mesh):
    fn = make_train_step(make_loss_fn("focal"), mesh=mesh)
    st, metrics = fn(st, pm.shard_batch(batch, mesh))
    out = {f"p/{k}": v for k, v in full_params(st).items()}
    out["loss"] = float(metrics["loss"])
    out["grad_norm"] = float(metrics["grad_norm"])
    return out


def local_shapes(st):
    return {f"shape/{'/'.join(p)}": np.array(w.shape)
            for p, w in zip(st.paths, st.leaves())}


def tagged(prefix, d):
    return {f"{prefix}/{k}": v for k, v in d.items()}


def tp_forward(params, x, mesh, geom=GEOM):
    m = module(params, geom).eval()
    local = pm.shard_params(torch_tree(params), mesh, geom["num_heads"])
    rows = pm.shard_batch({"x": x}, mesh)["x"]
    calls = att._context["tp_calls"]
    with torch.no_grad(), att.attention_sharding(mesh):
        logits = module_tree_apply(m)({"params": local}, rows)
    return logits.numpy(), att._context["tp_calls"] - calls


def tp_job(world, d, out):
    params = tree_from_npz(os.path.join(d, "params.npz"))
    params3 = tree_from_npz(os.path.join(d, "params3.npz"))
    data = dict(np.load(os.path.join(d, "data.npz")))
    x = torch.from_numpy(data["x"])
    batch = {"image": data["x"], "label": data["y"]}
    layouts = [(1, 2)] if world == 2 else [(2, 2), (1, 4)]
    for dp, tp in layouts:
        mesh = pm.make_mesh(data=dp, model=tp, device_type="cpu")
        key = f"{dp}x{tp}"
        out[f"fwd_{key}"], out[f"calls_{key}"] = tp_forward(params, x, mesh)
    dp, tp = layouts[0]
    key = f"{dp}x{tp}"
    mesh = pm.make_mesh(data=dp, model=tp, device_type="cpu")
    m = module(params)
    layout = pm.tp_layout(torch_tree(params), mesh, GEOM["num_heads"])
    st = new_state(m, params, layout)
    out.update(local_shapes(st))
    out.update(tagged(f"grad_{key}", mesh_grads(
        st, x, torch.from_numpy(data["y"]), mesh)))
    st = new_state(m, params, layout, tx=SGD())
    calls = att._context["tp_calls"]
    out.update(tagged(f"step_{key}", one_step(st, batch, mesh)))
    out[f"step_calls_{key}"] = att._context["tp_calls"] - calls
    # the head's dropout masks: the same on every model rank of a data group
    st = new_state(module(params, dropout=0.1), params, layout, tx=SGD())
    out.update(tagged(f"drop_{key}", one_step(st, batch, mesh)))
    # indivisible heads: three heads over the model axis
    mesh = pm.make_mesh(data=1, model=world, device_type="cpu")
    out["fwd3"], out["calls3"] = tp_forward(params3, x, mesh, GEOM3)
    # FSDP over every rank
    mesh = pm.make_mesh(data=world, model=1, device_type="cpu")
    layout = pm.fsdp_layout(torch_tree(params), mesh, FSDP_MIN)
    base = module_tree_apply(m)

    def fsdp_apply(v, xx, **kw):
        return base({"params": layout.gather_tree(
            v["params"], (pm.DATA_AXIS,), differentiable=True)}, xx, **kw)

    st = new_state(m, params, layout, fsdp_apply)
    out.update(tagged("fsdp", local_shapes(st)))
    out["fsdp_mu_qkv"] = np.array(st.opt_state["mu"][st.paths.index(
        ("vit", "block0", "attn", "qkv", "kernel"))].shape)
    out.update(tagged("fsdp_grad", mesh_grads(
        st, x, torch.from_numpy(data["y"]), mesh)))
    st = new_state(m, params, layout, fsdp_apply, tx=SGD())
    out.update(tagged("fsdp_step", one_step(st, batch, mesh)))


def pp_forward(params, x, mesh, micro, geom=GEOM, remat=False):
    m = module(params, geom).eval()
    rows = pm.shard_batch({"x": x}, mesh)["x"]
    with torch.no_grad():
        return pp.pipeline_apply(m, {"params": torch_tree(params)}, rows,
                                 mesh, microbatches=micro,
                                 remat=remat).numpy()


def pp_state(params, mesh, micro, remat=False, geom=GEOM, dropout=0.0,
             tx=None):
    m = module(params, geom, dropout)
    packed = pp.pack_pipeline_params({"params": torch_tree(params)},
                                     geom["depth"])
    layout = pp.pipe_layout(packed["params"], mesh, geom["num_heads"])

    def apply_fn(v, xx, *, train=False, generator=None):
        return pp.pipeline_apply(m, v, xx, mesh, microbatches=micro,
                                 train=train, generator=generator,
                                 remat=remat)

    return new_state(m, packed["params"], layout, apply_fn, tx)


def pp_job(world, d, out):
    params = tree_from_npz(os.path.join(d, "params.npz"))
    params3 = tree_from_npz(os.path.join(d, "params3.npz"))
    data = dict(np.load(os.path.join(d, "data.npz")))
    x = torch.from_numpy(data["x"])
    y = torch.from_numpy(data["y"])
    batch = {"image": data["x"], "label": data["y"]}
    cases = ([(1, 2, 1, 2), (1, 2, 1, 4)] if world == 2 else
             [(2, 2, 1, 4), (1, 4, 1, 4), (2, 2, 1, 2), (1, 2, 2, 2),
              (1, 2, 2, 4)])
    for data_n, pipe, model, micro in cases:
        mesh = pm.make_pipe_mesh(pipe, data=data_n, model=model,
                                 device_type="cpu")
        key = f"{data_n}x{pipe}x{model}m{micro}"
        calls = att._context["tp_calls"]
        out[f"fwd_{key}"] = pp_forward(params, x, mesh, micro)
        out[f"calls_{key}"] = att._context["tp_calls"] - calls
    # gradients with and without remat, and one step, on the first layout
    data_n, pipe, model, micro = cases[0]
    mesh = pm.make_pipe_mesh(pipe, data=data_n, model=model,
                             device_type="cpu")
    for remat in (False, True):
        st = pp_state(params, mesh, micro, remat)
        out.update(tagged(f"grad_remat{int(remat)}",
                          mesh_grads(st, x, y, mesh)))
    st = pp_state(params, mesh, micro, tx=SGD())
    out.update(local_shapes(st))
    out.update(tagged("step", one_step(st, batch, mesh)))
    st = pp_state(params, mesh, micro, dropout=0.1, tx=SGD())
    out.update(tagged("drop", one_step(st, batch, mesh)))
    if world == 4:
        mesh = pm.make_pipe_mesh(2, data=1, model=2, device_type="cpu")
        st = pp_state(params, mesh, 2)
        out.update(tagged("tpp_shape", local_shapes(st)))
        calls = att._context["tp_calls"]
        out.update(tagged("tpp_grad", mesh_grads(st, x, y, mesh)))
        st = pp_state(params, mesh, 2, tx=SGD())
        out.update(tagged("tpp_step", one_step(st, batch, mesh)))
        out["tpp_calls"] = att._context["tp_calls"] - calls
        out["fwd3_tpp"] = pp_forward(params3, x, mesh, 2, GEOM3)


class Log:
    def __init__(self):
        self.records = []

    def log(self, record, step=None):
        self.records.append(dict(record))


def trainer_job(world, d, out):
    """``Trainer.fit`` of 2 epochs under each layout on this rank's rows
    of the global batches; a pipeline run saves, is resumed and goes on."""
    from vit_spoof_detection_pda_tpu_torch.utils.checkpoint import (
        CheckpointManager, load_params_from_dir)

    params = tree_from_npz(os.path.join(d, "params.npz"))
    data = dict(np.load(os.path.join(d, "data.npz")))
    images, labels = data["train_x"], data["train_y"]
    val_x, val_y = data["val_x"], data["val_y"]
    bs = int(data["bs"])
    rank = dist.get_rank()

    def feeds(n_data, coord):
        per, vper = bs // n_data, len(val_x) // n_data

        def train_batches(epoch, skip=0):
            idx = np.random.default_rng(epoch).permutation(len(images))
            for bi, i in enumerate(range(0, len(images) - bs + 1, bs)):
                if bi >= skip:
                    j = idx[i:i + bs][coord * per:(coord + 1) * per]
                    yield {"image": images[j], "label": labels[j]}

        def val_batches():
            lo = coord * vper
            yield {"image": val_x[lo:lo + vper], "label": val_y[lo:lo + vper]}

        return train_batches, val_batches

    layouts = ({"tp": {"model_parallel": 2}, "fsdp": {"fsdp": True},
                "pp": {"pipeline_parallel": 2}} if world == 2 else
               {"dp": {}, "tp": {"data_parallel": 2, "model_parallel": 2},
                "fsdp": {"fsdp": True},
                "pp": {"data_parallel": 2, "pipeline_parallel": 2},
                "tp_pp": {"pipeline_parallel": 2, "model_parallel": 2}})
    for name, sharding in layouts.items():
        over = {**TRAIN_CFG, "sharding.fsdp_min_size": FSDP_MIN,
                **{f"sharding.{k}": v for k, v in sharding.items()}}
        cfg = Config().with_overrides(over)
        ckpt = (CheckpointManager(os.path.join(d, f"{name}_ckpt{world}"))
                if name == "pp" else None)
        mesh = pm.mesh_from_config(cfg.sharding, device_type="cpu")
        tb, vb = feeds(pm.axis_sizes(mesh)["data"],
                       pm.axis_rank(mesh, "data"))
        log = Log()
        t = Trainer(cfg, module(params), train_batches=tb,
                    val_batches=vb, steps_per_epoch=len(images) // bs,
                    variables={"params": params}, device="cpu", logger=log,
                    checkpoints=ckpt)
        out[f"{name}/mesh"] = np.array(t.mesh.mesh.shape)
        out.update(tagged(name, local_shapes(t.state)))
        out[f"{name}/mu_shapes"] = np.array(
            [list(m.shape) + [0] * (3 - m.ndim) for m in
             t.state.opt_state["mu"]])
        t.fit()
        epochs = [r for r in log.records if "train/epoch" in r]
        for key in ("train/loss", "val/loss", "val/auc", "val/f1",
                    "val/optimal_threshold"):
            out[f"{name}/fit/{key}"] = np.array([e[key] for e in epochs])
        out.update(tagged(f"{name}/full", full_params(t.state)))
        if name != "pp":
            continue
        # the checkpoint holds the whole packed tree; a fresh trainer
        # restores its slices and goes on from epoch 1
        mgr = CheckpointManager(os.path.join(d, f"pp_resume{world}"))
        mgr.save(int(t.state.step), t.state)
        dist.barrier()
        t2 = Trainer(cfg, module(params), train_batches=tb,
                     val_batches=vb, steps_per_epoch=len(images) // bs,
                     variables={"params": params}, device="cpu",
                     logger=Log())
        t2.state = mgr.restore(t2.state)
        out["pp/resume_equal"] = all(
            torch.equal(a, b) for a, b in zip(t.state.leaves(),
                                              t2.state.leaves())) and all(
            torch.equal(a, b) for a, b in zip(t.state.opt_state["mu"],
                                              t2.state.opt_state["mu"]))
        out["pp/resume_step"] = int(t2.state.step)
        best = t2.fit(start_epoch=1)
        out["pp/resume_val_f1"] = float(best["val_f1"])
        # a pipeline run's eval step against the module forward over the
        # checkpoint's unpacked tree
        variables, _ = load_params_from_dir(os.path.join(d, f"pp_resume{world}"))
        out["pp/ckpt_unpacked"] = "block0" in variables["params"]["vit"]
        vx = torch.from_numpy(val_x[:4])
        plain = module(flat_to_np(variables["params"])).eval()
        with torch.no_grad():
            out["pp/ckpt_logits"] = plain(vx).numpy()
        out["pp/eval_logits"] = t.eval_step(t.state.params, vx)[
            "logits"].numpy()
        if rank == 0:
            out["pp/ckpt_files"] = np.array(sorted(os.listdir(
                os.path.join(d, f"pp_resume{world}"))))


def flat_to_np(tree):
    return {k: flat_to_np(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in tree.items()}


def main():
    job, rank, world, port, d = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    pm.init_multi_host("gloo", init_method=f"tcp://127.0.0.1:{port}",
                       rank=rank, world_size=world)
    try:
        out = {}
        {"tp": tp_job, "pp": pp_job, "trainer": trainer_job}[job](
            world, d, out)
        np.savez(os.path.join(d, f"{job}{world}_rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
