"""Measurement tools for the card: profiles, A/B runs of two checkouts and
build times.  Each is run as ``python -m bachelors_tpu_torch.tools.<name>``
and needs a CUDA device (the build times need only ``nvcc``)."""
