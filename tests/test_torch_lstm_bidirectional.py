"""The port's bidirectional recurrent layers (GravesBidirectionalLSTM and
Bidirectional in each mode) against the JAX package's, in float64 on the
CPU, by the check of test_torch_lstm_layers.py: outputs and gradients,
masked and unmasked, the JAX layer with its helpers off and on. The
reverse direction runs the K7 scan's plain version on the time-flipped
input projection, or the per-step loop backwards in time when masked.
Tolerance 1e-10.
"""
import pytest

from tests.test_torch_lstm_layers import MODES, _layers, check_layer, two_way


@pytest.mark.parametrize("masked,helpers", MODES)
@pytest.mark.parametrize("name", sorted(n for n in _layers() if two_way(n)))
def test_bidirectional_layer_matches_jax(name, masked, helpers):
    check_layer(name, masked, helpers)
