"""Serving: a trained model as a self-contained `torch.export` artifact.

Counterpart of `efficient_rpe_vit_tpu/serve/`: the deterministic forward
is traced once with the trained weights inside and a symbolic batch, saved
with `torch.export.save`, and served from any process that imports this
package, with no model code, config or factory. Importing it registers the
port's custom ops (`ops/kernels/_library.py`), which an exported program
names as nodes of its graph and a loading process must know; nothing of
`models/`, `configs/` or `train/` is imported.
"""

from .export import export_forward, load_exported, save_exported

__all__ = ["export_forward", "save_exported", "load_exported"]
