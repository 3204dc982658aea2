"""Training of the port.

`schedule.py` — the LR schedule.
`state.py`    — the optimizer chain (clip, AdamW, EMA, accumulation) and
                the train state, updated in place.
`step.py`     — the train and eval steps.
"""
