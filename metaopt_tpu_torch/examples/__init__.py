"""Hunt-able user scripts for the BASELINE configs, run by the port's CLI.

Each is a script (``python -m metaopt_tpu_torch hunt ... <script> ...``);
importing one does nothing.
"""
