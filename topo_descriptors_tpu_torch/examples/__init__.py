"""Runnable examples of the port, each a module with a ``main``:

* :mod:`.compute_topo_descriptors` — the reference's batch: every
  descriptor family over its twelve scales (100 m to 100 km);
* :mod:`.walkthrough` — the README tour of the public API, with timings.

Run them as ``python -m topo_descriptors_tpu_torch.examples.<name>``; both
take ``--device cpu`` to run the plain PyTorch versions without a GPU.
"""
