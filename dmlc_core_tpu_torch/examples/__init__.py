"""Runnable examples of the port (counterparts of the JAX package's
``examples/``), each a module run with ``python -m``:
:mod:`.elastic_train` (elastic data-parallel training that survives a
worker's death, ``examples/elastic_train.py``).  Importing one runs
nothing."""
