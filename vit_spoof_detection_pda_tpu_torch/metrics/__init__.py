"""Metrics of the port.

`parity.py` — the float64 sklearn replica (ROC, AUC, EER, the threshold
              rows, the test.py metric set) the eval artifacts use.
"""
