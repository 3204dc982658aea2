"""Portable serving artifacts (counterpart of the JAX package's
``models/artifact.py``): freeze a serving program to disk and run it with
no model class, transform recipe or label convention on the consumer's
side.

An artifact directory holds three files (versioned by ``meta.json``):

- ``serving.pt2``: a ``torch.export`` program of ``infer(weights,
  batch_u8) -> {"prob1": P(live), "pred"}`` over raw ``uint8 [B, H, W,
  3]`` faces, the normalization inside.  The weights are call-time
  inputs, as in the JAX package, so the program file stays small.
- ``weights.npz``: the weight tree's leaves as raw little-endian bytes
  (uint8 entries), the JAX package's codec; each leaf's dtype, shape and
  the tree's structure are in the descriptor.  bf16 leaves decode through
  ``torch.frombuffer``, so numpy never has to name bf16.
- ``meta.json``: the JAX package's keys, with ``torch_version`` for
  ``jax_version``, sha256 checksums of both files.

Modes, as in the JAX package:

- ``"module"``: the eval program (``eval/runner.py::infer_body``) over
  ``torch.func.functional_call`` of the module on the weights (its state
  dict), f32 by default, with a symbolic batch dimension (one program,
  any B) or a fixed one; platforms ``["cpu", "cuda"]``.
- ``"fastserve"`` / ``"lowlat"`` (optionally the int8 stream) /
  ``"batch_grid"``: the kernel regimes of ``models/fastserve.py``, built
  by its ``serving_program`` (so a frozen program cannot drift from the
  live one), fixed batch, platforms ``["cuda"]``.

The hand-written kernels are ctypes calls, which ``torch.export`` cannot
trace; while a program is exported the kernel wrappers call their
``vsd::`` operators instead (``ops/attention.py``, ``ops/lowlat.py``),
whose CUDA implementation launches the kernel and whose CPU one is the
plain version.  So an artifact exports from a host without a card, as the
JAX package cross-lowers its Mosaic calls, and a kernel-mode artifact
loaded with ``device="cpu"`` runs the plain versions.  Loading imports the
operators first, and moves the program to the device it runs on
(``torch.export.passes.move_to_device_pass``: tensors the trace created
carry the export's device).  A JAX artifact (``serving.stablehlo``) is
refused, not run.

Fleet artifacts (``export_serving(mesh=...)``, module mode): the program
is the per-rank eval program at ``batch_size / n`` rows, ``n`` the
mesh's data axis, and ``meta.json`` records the mesh.  Loading needs a
process group (or a mesh) of the recorded size; each rank runs the
frozen program on its block of the global batch
(``parallel/mesh.py::shard_batch``) and the scores are gathered back in
batch order, so every rank returns the global batch's.
"""

from __future__ import annotations

import hashlib
import io
import json
from pathlib import Path

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..device import exact_f32_matmul, resolve_device

ARTIFACT_VERSION = 1
_EXPORTED_FILE = "serving.pt2"
_JAX_EXPORTED_FILE = "serving.stablehlo"
_WEIGHTS_FILE = "weights.npz"
_META_FILE = "meta.json"

_KERNEL_MODES = ("fastserve", "lowlat", "batch_grid")


# ---------------------------------------------------------------------------
# tree <-> flat-bytes codec (dict/list/tuple trees of tensors)

def _dtype_name(dtype) -> str:
    """numpy's name of a torch dtype (the JAX codec's spelling)."""
    return str(dtype).removeprefix("torch.")


def _tree_spec(tree, leaves_out, path=""):
    """JSON-able structure descriptor; appends ``(key, tensor)`` to
    ``leaves_out``."""
    if isinstance(tree, dict):
        return {"kind": "dict",
                "items": {k: _tree_spec(tree[k], leaves_out,
                                        f"{path}/{k}" if path else str(k))
                          for k in sorted(tree)}}
    if isinstance(tree, (list, tuple)):
        return {"kind": "list" if isinstance(tree, list) else "tuple",
                "items": [_tree_spec(v, leaves_out, f"{path}/{i}")
                          for i, v in enumerate(tree)]}
    t = tree.detach()
    key = f"leaf_{len(leaves_out):05d}"
    leaves_out.append((key, t))
    return {"kind": "leaf", "key": key, "path": path,
            "dtype": _dtype_name(t.dtype), "shape": list(t.shape)}


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes, little-endian as the card and the host store
    them, as a flat uint8 array."""
    return t.cpu().contiguous().reshape(-1).view(torch.uint8).numpy()


def _tree_unspec(spec, leaves, device=None):
    if spec["kind"] == "dict":
        return {k: _tree_unspec(v, leaves, device)
                for k, v in spec["items"].items()}
    if spec["kind"] in ("list", "tuple"):
        seq = [_tree_unspec(v, leaves, device) for v in spec["items"]]
        return seq if spec["kind"] == "list" else tuple(seq)
    dtype = getattr(torch, spec["dtype"])
    raw = bytearray(np.asarray(leaves[spec["key"]], np.uint8).tobytes())
    # frombuffer refuses an empty buffer
    t = (torch.frombuffer(raw, dtype=dtype) if raw
         else torch.empty(0, dtype=dtype)).reshape(spec["shape"])
    return t if device is None else t.to(device)


def _save_weights(path: Path, tree):
    leaves: list = []
    spec = _tree_spec(tree, leaves)
    buf = io.BytesIO()
    np.savez(buf, **{k: _raw_bytes(t) for k, t in leaves})
    path.write_bytes(buf.getvalue())
    return spec


def _load_weights(path: Path, spec, device=None):
    with np.load(io.BytesIO(path.read_bytes())) as z:
        leaves = {k: z[k] for k in z.files}
    return _tree_unspec(spec, leaves, device)


def _sorted_tree(tree):
    """The tree with every dict's keys in sorted order: the order the
    codec restores, which the exported program's input spec must match."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted_tree(v) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# export

def temper_probs(p, temperature):
    """``sigmoid(logit(p) / T)`` in f32, the deploy-side half of
    temperature scaling (JAX :115).  The clip is 1e-7, the tightest f32
    can express at the upper side (``1 - 1e-12`` rounds to 1 in f32)."""
    eps = 1e-7
    p = torch.clamp(p.float(), eps, 1.0 - eps)
    z = (torch.log(p) - torch.log1p(-p)) / float(temperature)
    return torch.sigmoid(z)


def _score_infer_fn(raw_fn, threshold: float = 0.5, temperature=None,
                    **kwargs):
    """``infer(weights, batch_u8) -> {"prob1", "pred"}`` around a kernel
    regime's ``raw_fn(weights, batch, **kwargs) -> P(live)``."""
    def infer(weights, batch_u8):
        out = raw_fn(weights, batch_u8, **kwargs)
        score = (out if out.ndim == 1 else out[:, 1]).float()
        if temperature is not None:
            score = temper_probs(score, temperature)
        return {"prob1": score, "pred": (score > threshold).to(torch.int32)}
    return infer


def _module_infer_fn(module, *, input_dtype, threshold, temperature):
    """``infer(weights, batch_u8)``: the eval program
    (``eval/runner.py::infer_body``) on the module called with
    ``weights`` (a state dict) in place of its own tensors."""
    from ..eval.runner import infer_body

    module.eval()

    def infer(weights, batch_u8):
        return infer_body(
            lambda x: torch.func.functional_call(module, weights, (x,)),
            batch_u8, input_dtype=input_dtype, threshold=threshold,
            temperature=temperature)
    return infer


class _Program(torch.nn.Module):
    """The module ``torch.export`` traces: ``forward(weights, batch_u8)``,
    holding no tensors of its own (the weights are inputs)."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, weights, batch_u8):
        return self.fn(weights, batch_u8)


def export_serving(module, *, mode: str = "module", batch_size=None,
                   img_size: int = 224, input_dtype=torch.float32,
                   platforms=None, mesh=None, int8_weights: bool = False,
                   threshold: float = 0.5, temperature=None, device=None):
    """``(exported, weights, meta)`` of a serving program (JAX :146).

    ``module``: a port model holding its weights (``ViTAntiSpoof`` for the
    kernel modes; any registry model in module mode).  ``batch_size=None``
    exports a symbolic batch dimension, module mode only (traced at an
    example batch of 2, since ``torch.export`` specializes sizes 0 and 1).
    ``input_dtype`` is the module path's compute dtype; the kernel modes
    are bf16.  ``int8_weights`` (``mode="lowlat"`` only) freezes the int8
    encoder stream.  ``threshold`` is the operating point baked into
    ``pred`` (P(live) > threshold); ``temperature`` bakes
    ``sigmoid(logit(p) / T)`` into ``prob1``.  ``device``: where the
    kernel modes pack their weights and trace (the card unless
    ``"cpu"``; no card is needed to export, the operators' fake
    implementations give the shapes); module mode traces where the
    module's parameters are.  ``mesh``: the FLEET flavor (module mode, a
    concrete ``batch_size`` that divides by the data axis): the per-rank
    program over ``batch_size / n`` rows, the mesh in the descriptor."""
    from ..eval.runner import module_device
    from .vit import ViTAntiSpoof

    threshold = float(threshold)
    if not 0.0 < threshold < 1.0:
        raise ValueError(f"threshold must be in (0, 1), got {threshold}")
    if temperature is not None:
        temperature = float(temperature)
        if temperature <= 0.0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
    rank_batch = None if batch_size is None else int(batch_size)
    if mesh is not None:
        if mode != "module":
            raise ValueError(
                "mesh export is module-mode only (the kernel regimes "
                "shard at call time — use the live "
                "serving_forward_sharded path on the fleet)")
        if batch_size is None:
            raise ValueError("mesh export needs a concrete batch_size "
                             "(divisible by the data axis)")
        ndata = _fleet_data_axis(mesh)
        if int(batch_size) % ndata:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"the {ndata}-way data axis")
        rank_batch = int(batch_size) // ndata

    geom = {}
    if isinstance(module, ViTAntiSpoof):
        geom = dict(num_heads=module.num_heads, depth=module.depth,
                    patch_size=module.patch_size, norm_eps=module.norm_eps)

    if mode == "module":
        if int8_weights:
            raise ValueError("int8_weights packs the lowlat encoder "
                             "stream; mode='module' exports the plain "
                             "eval program (pass mode='lowlat')")
        infer = _module_infer_fn(module, input_dtype=input_dtype,
                                 threshold=threshold,
                                 temperature=temperature)
        weights = {k: v.detach() for k, v in module.state_dict().items()}
        device = module_device(module)
        if platforms is None:
            platforms = ("cpu", "cuda")
    elif mode in _KERNEL_MODES:
        if batch_size is None:
            raise ValueError(
                f"mode={mode!r} runs fixed-shape kernels; pass a concrete "
                "batch_size (symbolic batch needs mode='module')")
        if platforms is None:
            platforms = ("cuda",)
        elif tuple(platforms) != ("cuda",):
            raise ValueError(f"mode={mode!r} runs CUDA kernels; platforms "
                             f"must be ('cuda',), got {platforms}")
        from .fastserve import serving_program
        device = resolve_device(device)
        weights, raw, kw = serving_program(module, mode=mode,
                                           int8_weights=int8_weights,
                                           device=device)
        infer = _score_infer_fn(raw, threshold=threshold,
                                temperature=temperature, **kw)
    else:
        raise ValueError(f"unknown serving mode {mode!r}")

    weights = _sorted_tree(weights)
    example_b = 2 if batch_size is None else rank_batch
    batch = torch.zeros((example_b, img_size, img_size, 3), dtype=torch.uint8,
                        device=device)
    batch_dims = ({0: torch.export.Dim("b", min=1)} if batch_size is None
                  else None)
    with torch.no_grad(), exact_f32_matmul():
        exported = torch.export.export(
            _Program(infer), (weights, batch),
            dynamic_shapes=(tree_map(lambda _: None, weights), batch_dims),
            strict=False)

    meta = {
        "format_version": ARTIFACT_VERSION,
        "mode": mode,
        "platforms": list(platforms),
        "batch_size": None if batch_size is None else int(batch_size),
        "img_size": int(img_size),
        "input": {"dtype": "uint8",
                  "layout": "[B, H, W, 3] RGB, raw 0-255 (normalization "
                            "is inside the program)"},
        "output": {"prob1": "P(live); 1 = live (data/conventions.py)",
                   "pred": f"1 = live at P(live) > {threshold}"},
        "threshold": threshold,
        "temperature": temperature,
        "compute_dtype": ("bfloat16" if mode in _KERNEL_MODES
                          else _dtype_name(input_dtype)),
        "int8_weights": bool(int8_weights),
        "model": type(module).__name__,
        "geometry": geom,
        "torch_version": torch.__version__,
    }
    if mesh is not None:
        meta["mesh"] = {"axis_names": list(mesh.mesh_dim_names),
                        "shape": [int(s) for s in mesh.mesh.shape]}
    return exported, weights, meta


def _fleet_data_axis(mesh) -> int:
    """The data axis size of a fleet mesh, every other axis 1: a fleet
    shards the batch and replicates the weights (a model axis is
    tensor parallelism, item 9b)."""
    from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_sizes
    sizes = axis_sizes(mesh)
    if sizes.get(MODEL_AXIS, 1) > 1:
        raise NotImplementedError(
            "a fleet artifact over a model axis (tensor-parallel weights) "
            "is not ported: ROADMAP Queue 1 item 9b")
    other = {k: v for k, v in sizes.items() if k != DATA_AXIS and v > 1}
    if other:
        raise ValueError(f"a fleet artifact shards the batch over the "
                         f"data axis alone; the mesh also has {other}")
    return sizes.get(DATA_AXIS, 1)


def save_serving_artifact(out_dir, module, **kwargs):
    """Export and write the three-file artifact directory; returns the
    descriptor."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    exported, weights, meta = export_serving(module, **kwargs)
    # the program alone: the trace's example inputs hold the weights
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    prog = buf.getvalue()
    (out / _EXPORTED_FILE).write_bytes(prog)
    meta["weights_spec"] = _save_weights(out / _WEIGHTS_FILE, weights)
    # a truncated copy of the weight file would otherwise surface as
    # garbage scores, not an error
    meta["checksums"] = {
        _EXPORTED_FILE: hashlib.sha256(prog).hexdigest(),
        _WEIGHTS_FILE: hashlib.sha256(
            (out / _WEIGHTS_FILE).read_bytes()).hexdigest()}
    (out / _META_FILE).write_text(json.dumps(meta, indent=1))
    return meta


# ---------------------------------------------------------------------------
# load

class ServingArtifact:
    """A loaded artifact: ``artifact(batch_u8) -> {"prob1", "pred"}``
    (tensors on :attr:`device`).  ``meta`` is the descriptor, ``exported``
    the ``ExportedProgram`` on the device, ``weights`` the restored tree,
    moved to the device once here."""

    def __init__(self, exported, weights, meta, device, mesh=None):
        self.exported, self.meta, self.device = exported, meta, device
        self.weights, self.mesh = weights, mesh
        self._call = exported.module()

    def __call__(self, batch_u8):
        batch = torch.as_tensor(batch_u8).to(self.device)
        fixed = self.meta.get("batch_size")
        size = int(self.meta.get("img_size", 224))
        if (batch.dim() != 4 or tuple(batch.shape[1:]) != (size, size, 3)
                or (fixed is not None and batch.shape[0] != int(fixed))):
            raise ValueError(
                f"batch of shape {tuple(batch.shape)}; this artifact takes "
                f"uint8 [{fixed if fixed is not None else 'B'}, {size}, "
                f"{size}, 3]")
        if self.mesh is not None:
            from ..parallel.collectives import gather_rows
            from ..parallel.mesh import DATA_AXIS, shard_batch
            block = shard_batch({"batch": batch}, self.mesh)["batch"]
            with torch.no_grad(), exact_f32_matmul():
                out = self._call(self.weights, block)
            group = self.mesh.get_group(DATA_AXIS)
            return {k: gather_rows(v, group) for k, v in out.items()}
        with torch.no_grad(), exact_f32_matmul():
            return self._call(self.weights, batch)

    @property
    def threshold(self) -> float:
        """The operating point baked into the program's ``pred``."""
        return float(self.meta.get("threshold", 0.5))

    @property
    def temperature(self):
        """The calibration temperature baked into ``prob1``, or None."""
        t = self.meta.get("temperature")
        return None if t is None else float(t)


def load_serving_artifact(path, mesh=None, *, device=None) -> ServingArtifact:
    """Load an artifact directory onto ``device`` (the card unless
    ``"cpu"``; a kernel-mode artifact then runs the kernels' plain
    versions).  Refuses an unknown format version, a file whose sha256
    disagrees with the descriptor, and a JAX artifact.  A fleet artifact
    needs a process group of the recorded size (a data mesh over it is
    built) or a ``mesh`` of that size; a single-device artifact refuses
    a ``mesh``."""
    from torch.export.passes import move_to_device_pass

    from ..ops import attention, lowlat  # noqa: F401  (the vsd:: operators)

    p = Path(path)
    if not (p / _EXPORTED_FILE).exists() and (p / _JAX_EXPORTED_FILE).exists():
        raise ValueError(
            f"{p} holds a JAX artifact ({_JAX_EXPORTED_FILE}, a jax.export "
            "program); the PyTorch port loads only its own "
            f"{_EXPORTED_FILE} artifacts — re-export the checkpoint with "
            "`python -m vit_spoof_detection_pda_tpu_torch export-serving`")
    meta = json.loads((p / _META_FILE).read_text())
    ver = meta.get("format_version")
    if ver != ARTIFACT_VERSION:
        raise ValueError(f"artifact format {ver} != supported "
                         f"{ARTIFACT_VERSION} ({p})")
    blobs = {f: (p / f).read_bytes() for f in (_EXPORTED_FILE, _WEIGHTS_FILE)}
    for f, want in meta.get("checksums", {}).items():
        if hashlib.sha256(blobs[f]).hexdigest() != want:
            raise ValueError(
                f"artifact file {f} is corrupt (sha256 mismatch — "
                "truncated copy?)")
    device = resolve_device(device)
    exported = torch.export.load(io.BytesIO(blobs[_EXPORTED_FILE]))
    exported = move_to_device_pass(exported, device)
    with np.load(io.BytesIO(blobs[_WEIGHTS_FILE])) as z:
        leaves = {k: z[k] for k in z.files}
    weights = _tree_unspec(meta["weights_spec"], leaves, device)
    if meta.get("mesh"):
        from ..parallel import mesh as pmesh
        want = int(np.prod(meta["mesh"]["shape"]))
        if mesh is None:
            if pmesh.world_size() != want:
                raise ValueError(
                    f"fleet artifact was exported for {want} devices; "
                    f"{pmesh.world_size()} visible — pass a matching mesh "
                    "or run in a matching device context")
            mesh = pmesh.make_mesh(data=want, model=1,
                                   device_type=device.type)
        elif mesh.mesh.numel() != want:
            raise ValueError(f"fleet artifact needs {want} devices; the "
                             f"given mesh has {mesh.mesh.numel()}")
        else:
            _fleet_data_axis(mesh)
    elif mesh is not None:
        raise ValueError("this artifact was exported single-device; "
                         "re-export with export_serving(mesh=...) for "
                         "fleet serving")
    return ServingArtifact(exported, weights, meta, device, mesh=mesh)


def score_records(artifact: ServingArtifact, records, *,
                  batch_size: int = 64, num_workers: int = 8) -> dict:
    """Score ``data.manifest.Record``s through a loaded artifact (JAX
    :397): threaded host decode (the black-image fallback kept), the tail
    padded to the artifact's batch, one batch in flight
    (``eval/runner.py::score_batches``).  Returns ``{"prob1", "pred"}``
    aligned with ``records``.  A fixed-batch artifact pins
    ``batch_size``."""
    from ..data.loader import DataPipeline
    from ..eval.runner import score_batches

    if artifact.meta.get("batch_size") is not None:
        batch_size = int(artifact.meta["batch_size"])
    img_size = int(artifact.meta.get("img_size", 224))
    pipe = DataPipeline(records, batch_size=batch_size, img_size=img_size,
                        resize="exact", num_workers=num_workers,
                        shuffle=False, drop_last=False)
    prob1, pred = score_batches(artifact, pipe.batches(), len(records),
                                batch_size=batch_size,
                                device=artifact.device)
    return {"prob1": prob1, "pred": pred}
