"""The port's kernels and their plain versions. Importing the package
registers `datr_torch::ms_deform_attn` (ops/msda.py), the one thing a
`torch.export` artifact of the model (tools/export_model.py) needs."""

from . import msda  # noqa: F401
