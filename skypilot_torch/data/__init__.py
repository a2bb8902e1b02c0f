"""The port's data-side facades (``data/checkpoint.py``)."""
