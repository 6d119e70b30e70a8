from .device import resolve_device
from .import_flax import flax_to_state_dict, load_flax_variables, moe_mlp_state_dict

__all__ = ["resolve_device", "flax_to_state_dict", "load_flax_variables",
           "moe_mlp_state_dict"]
