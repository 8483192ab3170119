"""Entry points of the port's serving path (``serve.py``) and the step
functions it resolves through the function registry (``steps.py``)."""
