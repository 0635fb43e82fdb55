"""The JAX package's four example scripts, ported (``examples/``): each
runs as ``python -m torchrecsys_tpu_torch.examples.<name>`` on the card,
or with ``--device cpu`` on the CPU, and takes size flags so that it can
run small."""
