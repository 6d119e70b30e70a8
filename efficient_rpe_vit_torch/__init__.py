"""efficient_rpe_vit_torch — the PyTorch / CUDA port of efficient_rpe_vit_tpu.

The same models (softmax / FAVOR+ / ReLU attention × none / RoPE / KERPLE /
Circulant-STRING RPE), ported slice by slice to PyTorch on an NVIDIA
Hopper GPU. Module paths mirror the JAX package's so each counterpart is
easy to find; every Pallas kernel becomes a hand-written CUDA kernel under
`csrc/`, bound in `ops/kernels/` beside its plain PyTorch version. The
JAX package stays the reference: nothing here imports it.

Entry points (`models.create_model`, `train.make_eval_step`,
`train.make_train_step`, `train.make_multi_step`,
`train.make_gather_multi_step`, `train.make_gather_multi_eval`,
`data.DeviceDataset`, `data.get_dataloaders`) run on the GPU unless the
caller passes `device="cpu"`; the CLIs
(`python -m efficient_rpe_vit_torch.experiments.train` / `.predict`) run
on the GPU unless given `--cpu`.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
