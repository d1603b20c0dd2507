"""The port's CUDA kernel on the card: the pair scorer against its plain
PyTorch version, and the serving engine on CUDA against the same engine on
the CPU.  These need an NVIDIA card (the kernel has no CPU mode) and skip
without one.  The file imports neither jax nor the repo's conftest fixtures,
so on the card's machine it runs as

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda

Tolerance 2e-2 on logits and 1e-2 on probabilities: the kernel and the plain
version round the same activations to bf16, but sum in other orders (the
logits with atomics), so an activation can land one bf16 step (2^-8) apart.
"""

import numpy as np
import pytest
import torch

from protnote_tpu_torch.models.fusion import ProtNoteConfig, init_protnote
from protnote_tpu_torch.models.proteinfer import ProteInferConfig, init_proteinfer
from protnote_tpu_torch.ops import pair_scorer as ps
from protnote_tpu_torch.serving import ServingEngine


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _folded(rng, d, width, n_hidden, device):
    def w(*shape):
        fan_in = shape[0]
        return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)
                                * np.float32(np.sqrt(6.0 / fan_in)))

    bf16 = torch.bfloat16
    return ps.FoldedOutputMLP(
        w1_p=w(d, width).to(device, bf16), w1_l=w(d, width).to(device, bf16),
        b1=(0.1 * w(width)).to(device, bf16), w1_prod=None,
        hidden=[(w(width, width).to(device, bf16), (0.1 * w(width)).to(device, bf16))
                for _ in range(n_hidden)],
        w_out=w(width).to(device, bf16), b_out=torch.tensor(0.3, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("n_hidden", [1, 2, 3])
def test_kernel_matches_plain_on_card(n_hidden):
    """1-3 hidden layers (every launch mode), a ragged last label chunk and
    a partial last row block."""
    dev = _card()
    rng = np.random.default_rng(n_hidden)
    folded = _folded(rng, 16, 256, n_hidden, dev)
    P_e = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32)).to(dev, torch.bfloat16)
    L_e = torch.from_numpy(rng.normal(size=(300, 16)).astype(np.float32)).to(dev, torch.bfloat16)
    before = ps.LAUNCHES
    got = ps.pair_logits_tiled(folded, P_e, L_e, label_tile=128)
    want = ps.pair_logits_tiled_reference(folded, P_e, L_e, label_tile=128)
    torch.cuda.synchronize()
    assert ps.LAUNCHES - before == 3 * n_hidden  # 3 label chunks
    assert float(want.std()) > 0.3
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-2, rtol=0)


@pytest.mark.cuda
def test_serving_engine_on_card_matches_cpu():
    dev = _card()
    L, K = 37, 2
    pi_cfg = ProteInferConfig(output_channels=24, kernel_size=5, num_resnet_blocks=2,
                              num_labels=L, compute_dtype=torch.bfloat16)
    pn_cfg = ProtNoteConfig(protein_embedding_dim=24, label_embedding_dim=16, latent_dim=32,
                            projection_head_num_layers=2, output_mlp_num_layers=3,
                            output_mlp_hidden_dim_scale_factor=4, label_tile=16,
                            inference_descriptions_per_label=K, compute_dtype=torch.bfloat16)
    pi_p, pi_s = init_proteinfer(torch.Generator().manual_seed(0), pi_cfg)
    pn_p, pn_s = init_protnote(torch.Generator().manual_seed(1), pn_cfg)
    ts = {"trainable": {"protnote": pn_p}, "model_state": pn_s,
          "enc_params": pi_p, "enc_state": pi_s}
    rng = np.random.default_rng(0)
    matrix = rng.normal(size=(L * K, 16)).astype(np.float32)
    vocab = [f"GO:{i:07d}" for i in range(L)]
    seqs = ["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n)) for n in (12, 40, 70)]
    kw = dict(buckets=(32, 64), max_batch=4)
    on_card = ServingEngine(ts, pi_cfg, pn_cfg, matrix, vocab, device=dev, **kw)
    on_cpu = ServingEngine(ts, pi_cfg, pn_cfg, matrix, vocab, device="cpu", **kw)
    before = ps.LAUNCHES
    got = on_card.score(seqs)
    assert ps.LAUNCHES > before
    np.testing.assert_allclose(got, on_cpu.score(seqs), atol=1e-2, rtol=0)
