"""Frozen FLOP and roofline arithmetic, from shapes alone.

`<family>.py`, one file per model family, gives its shapes and its train
step's FLOPs (`spec.family`): `vit.py` counts what every ViT configuration
shares; `<attention>.py`, one file per attention kind, counts that kind's
own products and the least time of its attention op. Nothing here reads
the program, its kernels' tiles or their names, so a later kernel that
fuses, splits or renames work is held to the same bound.
"""
