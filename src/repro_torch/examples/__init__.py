"""The example programs of the port, run as ``python -m
repro_torch.examples.<name>`` (the counterparts of the JAX package's
``examples/`` scripts): ``quickstart``, ``serve_batched``,
``train_nsa_e2e`` and ``fault_tolerant_training``. Each runs on the card
unless ``--device cpu`` is given."""
