"""Five steps of the port's `make_train_step` against the JAX package's,
on the CPU, for the first five models of ARCH_IDS: each reduced config
in fp32 from the JAX initial weights, both packages'
`synthetic_lm_batches` (their integers asserted equal; whisper's frame
embeddings drawn beside them), AdamW(lr=1e-3) with its clip and decay.
The metric histories within METRIC_RTOL, the parameters after the five
steps within STEP_ATOL of each leaf's scale (bars derived in
`tests/_torch_training_common.py`). The other five are in
`test_torch_training_steps_fleet10.py`."""
import pytest

from _torch_training_common import check_train_steps
from repro_torch.configs import ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS[:5])
def test_train_steps_match_jax(arch):
    check_train_steps(arch)
