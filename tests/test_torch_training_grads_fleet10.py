"""The port's training loss and its gradients against the JAX package,
on the CPU, for the last five models of ARCH_IDS (internlm2-20b,
gemma3-12b, llava-next-mistral-7b with its image embeddings, zamba2-7b,
deepseek-v3 with its MoE aux loss and its mtp head), as
`test_torch_training_grads.py` holds the first five."""
import pytest

from _torch_training_common import check_loss_and_grads
from repro_torch.configs import ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS[5:])
def test_loss_and_gradients_match_jax(arch):
    check_loss_and_grads(arch)
