"""Evaluation engine of the port (counterpart of the JAX package's
``eval/``).

`runner.py`  — batched inference over a dataset (the module forward on
               the card, tail padding to the batch size, one batch in
               flight).
`single.py`  — single-model evaluation with the test.py artifact contract
               (reference test.py:191-220, 319-451), pandas-free writers.
`harness.py` — cross-model sweep with the evaluate_all_models artifact
               contract + comparison reports (reference
               evaluate_all_models.py:122-176, 179-279, 358-434).
"""

from .runner import run_inference
from .single import run_single_model_eval
from .harness import run_cross_model_eval

__all__ = ["run_inference", "run_single_model_eval", "run_cross_model_eval"]
