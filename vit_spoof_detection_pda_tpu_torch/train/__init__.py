"""Training of the port.

`schedule.py` — the LR schedule.
`state.py`    — the optimizer chain (clip, AdamW, EMA, accumulation) and
                the train state, updated in place.
`step.py`     — the train and eval steps (pool batches gathered on the
                card).
`online.py`   — the online differential fan-out over decoded batches.
`pool.py`     — the device-resident image pool and its index streams.
`driver.py`   — the in-step augmentation preps and the group chains.
"""
