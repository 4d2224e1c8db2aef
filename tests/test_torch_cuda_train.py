"""Training on the card against the CPU (``chip_smoke.py`` phase 7 (a)):
the small f32 model with every loss on takes three stage-1 and two stage-2
steps on both devices from the same weights, batches and denoising draws;
losses and grad norm agree within 1e-4 relative at each step and the f32
masters within 1e-5 after them, apart from the doc tower's attention key
biases, whose true gradient is zero: on each device their computed
gradient stays within 1e-5 of the key weights'.  Then, with dropout on,
two epochs of ``TrainLoop`` in one run equal one epoch and a resumed one
bit for bit on the card.  Without a CUDA device the tests skip; the file imports neither
JAX nor the reference package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_train.py
"""

import pytest
import torch

from chip_smoke import _same_state, _small_train_world, train_small
from gdr_tpu_torch.models.dual_encoder import (DocEncoder, init_doc_encoder,
                                               tiny_doc_encoder_config)
from gdr_tpu_torch.train.loop import TrainLoop

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py phase 7 runs this "
                    "on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_small_train_steps_card_vs_cpu(dev):
    out = train_small(dev)
    assert out["metric_rel_err"] <= 1e-4 and out["param_max_abs_err"] <= 1e-5
    assert max(out["key_bias_grad_ratio"]) <= 1e-5


def test_resume_bit_equal_on_the_card(dev, tmp_path):
    cfg, index, ts, dev_data, dtok, dmask = _small_train_world(1, 0.1)

    def loop(name):
        tower = DocEncoder(tiny_doc_encoder_config(cfg.model.encoder_d_model))
        init_doc_encoder(tower, torch.Generator().manual_seed(1))
        return TrainLoop(cfg, index, ts, dev_data, str(tmp_path / name),
                         seed=3, doc_tokens=dtok, doc_tok_mask=dmask,
                         doc_encoder=tower, device=dev)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a = loop("a")
        a.run(max_epochs=2)
        loop("b").run(max_epochs=1)
        b = loop("b")
        b.run(max_epochs=2)
    finally:
        torch.use_deterministic_algorithms(False)
    _same_state("resume", a.state, b.state)
