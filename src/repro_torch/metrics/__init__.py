"""Energy and carbon model of the paper (a copy of the JAX package's
``metrics/energy.py``, which imports nothing of JAX)."""
