"""Device ops of the port (port of ``metaopt_tpu.ops``): flash attention,
its ring and Ulysses sequence-parallel forms, the blocked cross-entropy
and TPE's scoring math."""
