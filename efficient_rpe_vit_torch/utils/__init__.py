from .device import resolve_device
from .import_flax import flax_to_state_dict, load_flax_variables

__all__ = ["resolve_device", "flax_to_state_dict", "load_flax_variables"]
