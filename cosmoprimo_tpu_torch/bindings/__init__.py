"""Adapters exposing the port to external inference frameworks (cobaya,
cosmosis; cosmoprimo_tpu/bindings/). The external packages are optional and
imported only where a binding runs."""
