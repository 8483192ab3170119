"""Entry points of the port: serving (``serve.py``, which resolves its
decode step through the function registry) and training (``train.py``),
and the step functions both build (``steps.py``)."""
