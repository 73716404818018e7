"""The examples as entry points of the port (ports of ``examples/``).

Each runs as ``python -m repro_torch.examples.<name>`` and does what its
reference in ``examples/`` does, through the port's API:

* ``quickstart``: the simulated 4 GB transfer of the paper's Fig. 2 setup
  (MDTP, static chunking, Aria2, BitTorrent), then a real MDTP transfer
  over three throttled loopback mirrors.
* ``autotune_chunks``: the chunk-geometry sweep for the observed mirror
  throughputs, a batch of drifted scenarios in one call and the gradient
  polish of the grid's winner, on ``--device``.
* ``multisource_restore``: a ~64 MB state saved, then restored onto
  ``--device`` over three mirrors while the slowest is stopped 0.2 s in,
  bit-exact.
* ``train_100m``: a ~100M-parameter qwen3-family model trained through
  ``launch.train.run_training`` with its checkpoints and ``--resume``, on
  ``--device``.

An entry point that touches a device takes ``--device``: ``cuda`` by
default (it raises without a card), ``cpu`` for the plain path.  Nothing
falls back to the CPU.  Each ``main(argv)`` returns what it printed, as a
dict; those that start loopback mirrors take ``mirror(blobs, rate)``, the
factory that starts each one (``launch.train.start_mirror`` by default,
as ``run_training`` takes it).
"""
