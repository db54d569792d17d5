"""Plain references that decide `correct`.

Plain PyTorch in float64. Nothing here imports `jax`, `qrw_tpu` or
`qrw_tpu_torch`: every table is worked out again from the inputs that
the benchmark hands to both sides and from the configuration's file.
"""
