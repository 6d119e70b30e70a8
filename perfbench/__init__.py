"""The benchmark of the PyTorch / CUDA port (`efficient_rpe_vit_torch`).

One command runs one cell of `BENCHMARK.json` once:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data. A cell names a configuration
(`configs/<config>.json`) and a traffic mix (`mixes/<mix>.json`); the mix's
`kind` picks its runner (`runners/<kind>.py`); the configuration's
`family` picks its model (`spec.family`: the port's side in
`families/<family>.py`, the plain model in `reference/<family>.py`, the
shapes and step FLOPs in `counts/<family>.py`), and its `attention` the
frozen roofline arithmetic (`counts/<attention>.py`) and, in the `vit`
family, the plain reference's attention (`reference/attn_<attention>.py`);
each per-layer metric is a reader of its own (`metrics/<metric>.py`), which
sums the kernel groups it names (`kernel_groups/<group>.json`; no two
groups hold one kernel); the correctness limits of a cell are
`limits/<cell>.json`. A later change adds a cell, configuration, mix,
model family, metric or group as new files and entries.

Nothing here imports `jax` or the JAX package `efficient_rpe_vit_tpu`; the
plain reference (`reference/`) imports nothing of the port either.
"""
