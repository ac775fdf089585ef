"""The port's training loss and its gradients against the JAX package,
on the CPU, for the first five models of ARCH_IDS (whisper-large-v3,
olmo-1b, mamba2-780m, qwen3-8b, phi3.5-moe): each reduced config in
fp32, the JAX initial weights carried across by `convert`, one batch
(whisper with its frame embeddings). `loss_fn`'s metrics (ce, aux,
total) within METRIC_RTOL of the JAX `loss_fn`'s, every gradient leaf
within GRAD_ATOL of its scale of `jax.grad`'s (bars derived in
`tests/_torch_training_common.py`). The other five are in
`test_torch_training_grads_fleet10.py`."""
import pytest

from _torch_training_common import check_loss_and_grads
from repro_torch.configs import ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS[:5])
def test_loss_and_gradients_match_jax(arch):
    check_loss_and_grads(arch)
