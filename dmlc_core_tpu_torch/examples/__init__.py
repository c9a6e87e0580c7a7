"""Runnable examples of the port (counterparts of the JAX package's
``examples/``), each a module run with ``python -m``:
:mod:`.elastic_train` (elastic data-parallel training that survives a
worker's death, ``examples/elastic_train.py``) and
:mod:`.train_embed_shard` (training over a sharded embedding table that
survives a rank's death, ``examples/train_embed_shard.py``).  Importing
one runs nothing."""
