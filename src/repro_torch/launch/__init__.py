"""Entry points of the port and what they stand on: serving
(``serve.py``, which resolves its decode step through the function
registry) and training (``train.py``); the step functions both build
(``steps.py``); the meshes (``mesh.py``: the host mesh a run uses, the
abstract production meshes), the partition rules (``sharding.py``) and
the activation-constraint context (``shardctx.py``); and the analytic
dry run (``dryrun.py``: per-device bytes, the work of a step counted on
``meta`` tensors, its collectives placed by ``partition.py``,
``probe.py``'s per-kind decomposition, the inputs of ``specs.py``;
``hlo.py`` reads HLO text as the reference does and partition events
in the same format)."""
