"""One rank of tests/test_torch_sharded_serving.py's two-process run (it
holds no tests: the test starts one process per rank).

    python tests/test_torch_sharded_serving_worker.py <rank> <world> <port> <dir>

Imports torch and the port, never JAX.  Joins a gloo group on
``tcp://127.0.0.1:<port>``, reads the parameter trees and inputs the test
wrote to ``<dir>`` and writes ``<dir>/serve_rank<r>.npz``:

- ``serving_forward_sharded`` over a data-2 mesh, both heads, f32 and
  bf16, beside this process's unsharded forward of the whole batch, and
  the error a batch of 7 raises;
- ``run_inference(fastserve=True, mesh=)`` over the test's PNG faces,
  both heads;
- a fleet artifact exported by rank 0 and loaded by both ranks (without
  and with a mesh), and a single-device artifact loaded with a mesh;
- the mean-pooled ViTAntiSpoof over a seq-2 mesh: the backbone's
  features and the sequence-parallel dispatches of one forward, the
  logits, and the gradient of ``sum(logits^2)`` summed over the ranks.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from vit_spoof_detection_pda_tpu_torch.data.manifest import Record  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.eval.runner import run_inference  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.models import artifact as A  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.models import fastserve as F  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.models.convert import (  # noqa: E402
    load_jax_params, vit_linear_to_torch)
from vit_spoof_detection_pda_tpu_torch.models.vit import (  # noqa: E402
    ViTAntiSpoof, ViTLinearHead, fold_normalization)
from vit_spoof_detection_pda_tpu_torch.ops import attention as att  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.parallel import mesh as pm  # noqa: E402
from vit_spoof_detection_pda_tpu_torch.parallel.collectives import (  # noqa: E402
    all_reduce_sum)

IMG = 32
GEOM = dict(patch_size=16, embed_dim=64, depth=2, num_heads=2)
SP_GEOM = dict(patch_size=8, embed_dim=64, depth=2, num_heads=4, hidden=32)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


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


def antispoof(params, dtype=torch.float32):
    return load_jax_params(ViTAntiSpoof(**GEOM, hidden=16, gelu="tanh",
                                        img_size=IMG, dtype=dtype),
                           {"params": params}).eval()


def linear_head(params):
    m = ViTLinearHead(**GEOM, img_size=IMG).eval()
    m.load_state_dict({k: torch.tensor(v) for k, v in vit_linear_to_torch(
        {"params": params}).items()})
    return m


def sharded_forwards(as_params, lin_params, u8, mesh):
    out = {}
    heads = {"antispoof": (as_params, F.serving_forward),
             "linear": (lin_params, F.serving_forward_linear)}
    for head, (params, fn) in heads.items():
        folded = fold_normalization({"params": params})["params"]
        for name, dt in DTYPES.items():
            kw = dict(num_heads=2, depth=2, dtype=dt, device="cpu")
            out[f"sharded/{head}/{name}"] = F.serving_forward_sharded(
                folded, u8, mesh, fn=fn, **kw).numpy()
            out[f"single/{head}/{name}"] = fn(folded, u8, **kw).numpy()
    try:
        F.serving_forward_sharded(
            fold_normalization({"params": as_params})["params"], u8[:7],
            mesh, num_heads=2, depth=2, device="cpu")
    except ValueError as e:
        out["odd_batch_error"] = np.array(str(e))
    return out


def fastserve_inference(as_params, lin_params, d, rec_y, mesh):
    recs = [Record(path=os.path.join(d, f"face{i}.png"), label=int(y))
            for i, y in enumerate(rec_y)]
    out = {}
    for head, m in (("antispoof", antispoof(as_params, torch.bfloat16)),
                    ("linear", linear_head(lin_params))):
        res = run_inference(m, recs, batch_size=4, img_size=IMG,
                            num_workers=1, fastserve=True, mesh=mesh)
        out.update({f"infer/{head}/{k}": v for k, v in res.items()})
    return out


def fleet(as_params, u8, d, mesh, rank):
    m = antispoof(as_params)
    fleet_dir, single_dir = (os.path.join(d, "fleet"),
                             os.path.join(d, "single"))
    if rank == 0:
        A.save_serving_artifact(fleet_dir, m, mode="module", batch_size=8,
                                img_size=IMG, mesh=mesh)
        A.save_serving_artifact(single_dir, m, mode="module", batch_size=8,
                                img_size=IMG)
    dist.barrier()
    out = {}
    art = A.load_serving_artifact(fleet_dir, device="cpu")
    res = art(u8)
    out["fleet/prob1"], out["fleet/pred"] = (res["prob1"].numpy(),
                                             res["pred"].numpy())
    out["fleet/mesh_shape"] = np.array(art.meta["mesh"]["shape"])
    res = A.load_serving_artifact(fleet_dir, mesh, device="cpu")(u8)
    out["fleet_mesh/prob1"] = res["prob1"].numpy()
    try:
        A.load_serving_artifact(single_dir, mesh, device="cpu")
    except ValueError as e:
        out["single_with_mesh_error"] = np.array(str(e))
    return out


def mean_pool(sp_params, x, mesh):
    m = load_jax_params(ViTAntiSpoof(**SP_GEOM, img_size=IMG, pool="mean",
                                     dropout=0.0),
                        {"params": sp_params}).eval()
    x = torch.from_numpy(x)
    with att.attention_sharding(mesh):
        with torch.no_grad():
            calls = att._context["cp_calls"]
            feats = m.vit(x)
            calls = att._context["cp_calls"] - calls
        logits = m(x)
        (logits.float() ** 2).sum().backward()
    grads = [p.grad for p in m.parameters()]
    all_reduce_sum(grads, group=mesh.get_group(pm.SEQ_AXIS))
    out = {"mean/feats": feats.numpy(), "mean/cp_calls": calls,
           "mean/logits": logits.detach().numpy()}
    out.update({f"mean/grad/{k}": p.grad.numpy()
                for k, p in m.named_parameters()})
    return out


def main():
    rank, world, port, d = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    pm.init_multi_host("gloo", init_method=f"tcp://127.0.0.1:{port}",
                       rank=rank, world_size=world)
    try:
        as_params = tree_from_npz(os.path.join(d, "as_params.npz"))
        lin_params = tree_from_npz(os.path.join(d, "lin_params.npz"))
        sp_params = tree_from_npz(os.path.join(d, "sp_params.npz"))
        data = dict(np.load(os.path.join(d, "data.npz")))
        u8 = torch.from_numpy(data["u8"])
        dmesh = pm.make_mesh(data=2, model=1, device_type="cpu")
        out = sharded_forwards(as_params, lin_params, u8, dmesh)
        out.update(fastserve_inference(as_params, lin_params, d,
                                       data["rec_y"], dmesh))
        out.update(fleet(as_params, u8, d, dmesh, rank))
        smesh = pm.make_seq_mesh(seq=2, data=1, device_type="cpu")
        out.update(mean_pool(sp_params, data["x_sp"], smesh))
        np.savez(os.path.join(d, f"serve_rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
