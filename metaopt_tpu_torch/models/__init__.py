"""Demo model zoo (port of ``metaopt_tpu.models``): the seq2seq Transformer."""
