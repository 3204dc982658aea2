"""Program cache: export once, reload the lowered program from disk
(counterpart of the JAX package's ``utils/aot.py``).

The JAX package caches its compiled executables because its remote
compile costs minutes a program.  The port's kernels are nvcc-built and
cached by ``ops/_build.py``; what is left is the program around them.
:func:`cached_compile` traces ``fn`` with ``torch.export`` (the way
``models/artifact.py`` freezes a serving program; the kernels enter as
their ``vsd::`` operators), lowers it to the core ATen operator set
(``run_decompositions``) and keeps the lowered program on disk
(``torch.export.save``).  A later process traces again (cheap, and it
runs the wrappers' dispatch logic and launch accounting, as JAX's does)
and loads the lowered program instead of lowering it.  Nothing needs
``torch.compile`` or Triton.

Usage::

    infer = cached_compile(fn, (weights, batch), key="vit_b16_infer")
    out = infer(weights, batch)

The cache key is the caller's name plus a hash of the exported program
(its graph with every shape and dtype, and any tensors it holds) and the
torch version, the device name and the device count, so a code change
can never reuse a stale program.  Any cache failure (an unusable
directory, an unreadable entry, a failed write) falls back to an
uncached build; each writer writes a temporary file of its own and
renames it into place.
"""

from __future__ import annotations

import hashlib
import logging
import os

import torch
from torch.utils._pytree import tree_flatten

log = logging.getLogger(__name__)

# per-user cache location: a predictable world-writable /tmp path would
# let another local user plant a program under a guessable name
DEFAULT_CACHE_DIR = os.environ.get(
    "PAD_AOT_CACHE", os.path.join(os.path.expanduser("~"), ".cache",
                                  "pad_aot"))
SUFFIX = ".pt2"


class _Program(torch.nn.Module):
    """The module ``torch.export`` traces: ``forward(*args) = fn(*args)``,
    holding no tensors of its own."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _device_of(example_args) -> torch.device:
    leaves, _ = tree_flatten(example_args)
    for x in leaves:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _signature(exported, device: torch.device) -> str:
    """Hash of the exported program and the environment it runs in."""
    h = hashlib.sha256()
    h.update(str(exported).encode())
    for name, t in sorted({**exported.state_dict,
                           **exported.constants}.items()):
        if isinstance(t, torch.Tensor):
            h.update(name.encode())
            h.update(t.detach().cpu().contiguous().reshape(-1)
                     .view(torch.uint8).numpy().tobytes())
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    h.update("|".join([torch.__version__, kind, str(count)]).encode())
    return h.hexdigest()[:16]


def _spec(args):
    """The call signature a program takes: the tree's structure and each
    leaf's shape and dtype (a non-tensor leaf by value)."""
    leaves, tree = tree_flatten(args)
    return tree, [(tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor)
                  else x for x in leaves]


class _Resilient:
    """A loaded (or freshly lowered) program with a sticky fallback: a
    call-time failure of the cached program other than a ``TypeError``
    lowers the traced program again and runs that from then on.
    ``hit``: whether the program came from the cache."""

    def __init__(self, module, exported, spec, hit=False):
        self._module = module
        self._exported = exported
        self._spec = spec
        self._fresh = None
        self.hit = hit

    def __call__(self, *args):
        if _spec(args) != self._spec:
            # a caller-side mismatch (tree, shape or dtype): a fresh build
            # would refuse the same arguments, so it is not tried
            raise TypeError(
                "arguments do not match the compiled program's signature "
                f"(compiled for {self._spec[1]}, called with "
                f"{_spec(args)[1]})")
        if self._module is not None:
            try:
                return self._module(*args)
            except TypeError:
                raise
            except Exception as e:                 # noqa: BLE001
                log.warning("cached program failed at call time (%s) — "
                            "lowering afresh", e)
                self._module = None
        if self._fresh is None:
            self._fresh = self._exported.run_decompositions().module()
        return self._fresh(*args)


def cached_compile(fn, example_args: tuple, *, key: str,
                   cache_dir: str = None):
    """Export ``fn`` for ``example_args`` and lower it, with an on-disk
    cache of the lowered program.  Falls back to an uncached build on
    any cache failure.  The result is callable with arguments of the
    example's tree, shapes and dtypes; others raise ``TypeError``."""
    # always TRACE: it runs the wrappers' dispatch logic (the launch and
    # plan accounting callers assert on), and the program is the key
    exported = torch.export.export(_Program(fn), tuple(example_args),
                                   strict=False)
    spec = _spec(tuple(example_args))
    cache_dir = cache_dir or DEFAULT_CACHE_DIR
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError as e:
        log.warning("program cache dir %s unusable (%s) — lowering "
                    "uncached", cache_dir, e)
        return _Resilient(None, exported, spec)

    path = os.path.join(
        cache_dir,
        f"{key}-{_signature(exported, _device_of(example_args))}{SUFFIX}")
    if os.path.exists(path):
        try:
            module = torch.export.load(path).module()
            log.info("program cache hit: %s", path)
            return _Resilient(module, exported, spec, hit=True)
        except Exception as e:                     # noqa: BLE001
            log.warning("program cache entry %s unusable (%s) — lowering "
                        "afresh", path, e)

    lowered = exported.run_decompositions()
    # the program alone: the trace's example inputs (the weights among
    # them) would otherwise be saved with it
    lowered.example_inputs = None
    try:
        # a temporary file per writer: two writers sharing one name can
        # interleave and publish a corrupt entry
        tmp = os.path.join(cache_dir, f".{os.path.basename(path)}."
                           f"{os.getpid()}{SUFFIX}")
        torch.export.save(lowered, tmp)
        os.replace(tmp, path)
        log.info("program cache write: %s (%.1f MB)", path,
                 os.path.getsize(path) / 1e6)
    except Exception as e:                         # noqa: BLE001
        log.warning("program cache write failed (%s) — continuing "
                    "uncached", e)
    return _Resilient(lowered.module(), exported, spec)
