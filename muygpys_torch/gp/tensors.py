"""Frontend tensor-assembly names.

Counterpart of :mod:`muygpys_tpu.gp.tensors` for the serving slice.
"""

from muygpys_torch.ops import tensors as _t

crosswise_tensor = _t.crosswise_diffs
pairwise_tensor = _t.pairwise_diffs
make_heteroscedastic_tensor = _t.make_heteroscedastic_tensor
