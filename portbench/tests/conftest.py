"""The port benchmark's own tests: `python -m pytest portbench/tests -q`.

Each runs on one PyTorch thread, at a tiny configuration on the CPU;
a test that needs the card is marked `gpu` and skips without one."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the configurations' network, cut to a size a CPU test holds
TINY = dict(input_size=[32, 40, 48], total_levels=3, latent_levels=2, n0=4)
# limits at that size where the cell's own (set at its size on the card)
# do not hold: the tiny bf16 network's 34 leaves read 0.011-0.038 (grad
# p90) and 0.011 (change p90) on sound CPU runs; its float8 control
# 0.13-0.18 and 0.044-0.047. The tiny float32 network's first step's loss
# gap reads up to 1.3e-5 both sound and under its bfloat16 control, which
# at this size is no lower reading (the full size's: under 3.1e-6 against
# 1e-4 and more); its grad p90 reads up to 1.0e-4 and its change p90 up to
# 2.2e-4 on sound CPU runs, the control 0.015-0.021 and 0.0076-0.014.
TINY_LIMITS = {"oasis-train": {"grad1_p90_gap": 0.08, "change_p90_gap": 0.025},
               "brats-train-f32": {"grad1_p90_gap": 0.002, "change_p90_gap": 0.003}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
