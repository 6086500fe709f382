"""Small shared helpers (port of ``metaopt_tpu.utils``)."""
