"""Host-side helpers of the port."""

from elephas_tpu_torch.utils.serialization import dict_to_model, model_to_dict  # noqa: F401
