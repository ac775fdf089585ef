"""Five steps of the port's `make_train_step` against the JAX package's
for the last five models of ARCH_IDS (llava with its image embeddings,
deepseek with its aux and mtp metrics), as
`test_torch_training_steps.py` holds the first five."""
import pytest

from _torch_training_common import check_train_steps
from repro_torch.configs import ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS[5:])
def test_train_steps_match_jax(arch):
    check_train_steps(arch)
