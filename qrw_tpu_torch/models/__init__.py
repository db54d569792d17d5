"""Robot model constants."""

from qrw_tpu_torch.models.solo12 import Solo12Model, make_solo12  # noqa: F401
