"""The plain reference: ViT training in float32 with TF32 off, dense
attention, plain PyTorch. It imports neither `jax`, nor the JAX package,
nor anything of the port; it takes the inputs and weights the benchmark
makes (`perfbench/weights.py`) and works out everything else itself.
"""
