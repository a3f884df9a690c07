"""Overload plane of the port (a copy of the JAX package's overload/, cut
to what serves today): request deadlines and priority classes minted at
the frontend (deadline.py), the retriable ``EngineOverloadedError``
(errors.py), and the KV router's live load view with its spill counter
(load.py, metrics.py). Admission budgets, running preemption and the
frontend's 429s come with ROADMAP Queue 1 item 8."""
