"""Metrics of the port.

`parity.py` — the float64 sklearn replica (ROC, AUC, EER, the threshold
              rows, the test.py metric set) the eval artifacts use.
`device.py` — the same metrics as f32 tensor reductions on the card
              (validation's threshold table and 41-point sweep, AUC,
              EER).
"""

from . import device  # noqa: F401
