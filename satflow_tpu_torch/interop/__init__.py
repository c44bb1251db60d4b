"""Weight bridges into the PyTorch port: flax variables (``jax_weights``) and
reference-format torch state dicts (``torch_weights``, ``lightning``)."""

from satflow_tpu_torch.interop.torch_weights import (  # noqa: F401
    conv3d_kernel,
    conv_kernel,
    linear_kernel,
    load_torch_convlstm,
    load_torch_state_dict,
)
