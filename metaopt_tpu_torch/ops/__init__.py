"""Device ops of the port (port of ``metaopt_tpu.ops``): flash attention."""
