"""Training drivers and recipes (cosmoprimo_tpu/emulators/train/)."""
