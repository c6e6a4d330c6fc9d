"""The benchmark of cosmoprimo_tpu_torch on an NVIDIA GPU (see run.py)."""
