"""Parallel serving plans.  Only the pool pricing of ``parallel/plan.py``
is ported so far (one device)."""
