"""Frontend tensor-assembly names.

Counterpart of :mod:`muygpys_tpu.gp.tensors`.
"""

from muygpys_torch.ops import tensors as _t

fast_nn_update = _t.fast_nn_update
batch_features_tensor = _t.batch_features_tensor
make_fast_predict_tensors = _t.make_fast_predict_tensors
make_heteroscedastic_tensor = _t.make_heteroscedastic_tensor
crosswise_tensor = _t.crosswise_diffs
pairwise_tensor = _t.pairwise_diffs
