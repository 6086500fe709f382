"""Configuration and metadata helpers (port of ``metaopt_tpu.io``)."""
