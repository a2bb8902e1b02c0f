"""The port's copy of the JAX package's fault-injection contract
(``resilience/faults.py``): the ``checkpoint.save`` site of
``checkpoint/native.py`` fires through it."""
