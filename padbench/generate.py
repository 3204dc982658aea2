"""The general traffic generator: every input of a run comes from
``--seed`` and the traffic mix's parameters (``traffic/<name>.json``), the
same seed giving the same inputs.

Images are uint8 faces ``[S, S, 3]`` drawn on the card in one call and
kept in host memory as the program's callers hold them (pageable numpy),
in a pool of distinct images that the window cycles through.  Labels are
drawn with the cell's live share.  Arrivals are a closed loop: the next
batch or step as soon as the program takes the last.
"""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed derived from ``(seed, *salt)``; any whole ``seed``."""
    s = np.random.SeedSequence([int(seed) % 2 ** 64, *salt])
    return int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, salt: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, salt))
    return gen


def faces(seed: int, n: int, size: int, device, salt: int = 1) -> np.ndarray:
    """``n`` distinct uint8 images ``[n, size, size, 3]`` in host memory,
    drawn on ``device`` in one call."""
    gen = generator(seed, salt, device)
    x = torch.randint(0, 256, (n, size, size, 3), generator=gen,
                      device=device, dtype=torch.uint8)
    return x.cpu().numpy()


def live_share(ratio: str) -> float:
    """``"live:spoof"`` (``"1:3.87"``) -> the share of live images."""
    live, spoof = (float(v) for v in ratio.split(":"))
    return live / (live + spoof)


def labels(seed: int, n: int, ratio: str, salt: int = 2) -> np.ndarray:
    """``n`` int64 labels, 1 = live with the share ``ratio`` gives."""
    rng = np.random.default_rng(sub_seed(seed, salt))
    return (rng.random(n) < live_share(ratio)).astype(np.int64)


def pool(seed: int, traffic: dict, image_size: int, device) -> dict:
    """The cell's pool: ``{"images": uint8 [pool_batches * batch, S, S,
    3], "labels": int64 [...] (with a ``live_to_spoof`` ratio), "batch":
    B, "batches": pool_batches}``."""
    b, nb = int(traffic["batch"]), int(traffic["pool_batches"])
    out = {"images": faces(seed, b * nb, image_size, device),
           "batch": b, "batches": nb}
    if "live_to_spoof" in traffic:
        out["labels"] = labels(seed, b * nb, traffic["live_to_spoof"])
    return out

