"""Text-to-image LoRA training of the port (svi_tpu_torch.training.text_to_image)
and the attention backward it runs (the (B, N, S, D) route) against svi_tpu
on the CPU.

The UNet is the narrow SD 1.5 plan of tests/torch_sd_fixtures.py (two heads a
block), patched into both packages; both load the same seeded state dict.
svi_tpu's trainer draws its adapters from a JAX key; they are carried across
as a PEFT file (`pretrained_lora_path`), so both trainers start from the
same A and B and draw the same noise and timesteps from
`np.random.RandomState(seed)`.

Tolerances: the attention gradients, GRAD_TOL of tests/test_torch_attention_bwd.py
(f32 sums in another order); the trainer's losses and adapters, 1e-5
relative. The trainers run with the loss weighted by LOSS_WEIGHT (a
scheduler whose `training_weight` says so, the same in both packages), so
that every gradient stays far below AdamW's eps (1e-8) and the step is
linear in the gradient. At weight 1 the first steps are about lr * sign(g)
whatever |g|: the few gradient entries that cancel to ~1% of the median
(measured: 3.5e-8 against 3.5e-6) change by tens of percent between two f32
summation orders, and their entries move by up to 2 lr, which says nothing
of the gradients' agreement. The losses at weight 1 are held too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svi_tpu.models import sd as jsd
from svi_tpu.ops import attention as jattn
from svi_tpu.training import text_to_image as jt2i
from svi_tpu_torch.models import sd as tsd
from svi_tpu_torch.ops import attention as tattn
from svi_tpu_torch.training import text_to_image as tt2i

import torch_sd_fixtures as fx

GRAD_TOL = 2e-4
T2I_REL = 1e-5
LATENT = (1, 4, 8, 8)
LOSS_WEIGHT = 1e-9


def _weighted(scheduler_cls, weight):
    class Weighted(scheduler_cls):
        def training_weight(self, timestep):
            return weight

    return Weighted()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with fx.one_torch_thread():
        yield


@pytest.fixture(scope="module")
def unets():
    """(svi_tpu's params, the port's ParamTree) of the narrow UNet; the
    narrow plans stay patched for the module."""
    mp = pytest.MonkeyPatch()
    fx.patch_narrow_plans(mp)
    sd = tsd.sd_unet_state_dict(7, text_dim=fx.TEXT_DIM)
    yield jsd.sd_unet_params_from_torch(fx.to_numpy(sd)), tsd.sd_unet_params_from_torch(
        sd, device="cpu")
    mp.undo()


# ---------------------------------------------------------------------------
# the (B, N, S, D) backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_bnsd_backward_matches_jax_grad(d):
    """dq, dk, dv of `attention_bnsd` through torch.autograd against jax.grad
    of svi_tpu's `attention_bnsd` (its XLA path), at the SD 1.5 and SDXL head
    dims, two heads, 100 queries against 77 text keys: the route whose card
    backward is csrc/flash_bwd_f32.cu."""
    b, n, sq, sk = 2, 2, 100, 77
    assert tattn._bwd_route(n, d, sq, sk, sk) == "xla"
    rng = np.random.default_rng(d)
    q, g = (rng.standard_normal((b, n, sq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, n, sk, d)).astype(np.float32) for _ in range(2))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tattn.attention_bnsd(*leaves)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))

    def loss(q_, k_, v_):
        return jnp.sum(jattn.attention_bnsd(q_, k_, v_, force_xla=True) * g)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jnp.asarray(x) for x in (q, k, v)))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=GRAD_TOL, rtol=0)


# ---------------------------------------------------------------------------
# LoRA sites, fused weights, PEFT files
# ---------------------------------------------------------------------------


def _nonzero_lora(jparams, rank=3):
    lora = jt2i.init_lora(jax.random.PRNGKey(1), jparams, rank=rank)
    return jax.tree.map(lambda a: a + 0.05, lora)


def test_lora_sites_fused_weights_and_peft_bytes(unets):
    jparams, tparams = unets
    jsites = [".".join(map(str, s)) for s in jt2i.find_lora_sites(jparams)]
    tsites = [".".join(map(str, s)) for s in tt2i.find_lora_sites(tparams)]
    assert tsites == jsites and "blocks.1.transformer_blocks.0.attn1.to_q" in tsites
    assert len(tsites) == 16 * 2 * 4  # 16 transformer blocks, attn1 + attn2, q / k / v / out

    jl = _nonzero_lora(jparams)
    tl = tt2i.lora_from_state_dict(jt2i.lora_state_dict(jl), device="cpu")
    assert all(t.requires_grad and t.dtype == torch.float32 for ab in tl.values()
               for t in ab.values())
    # the PEFT tensors, byte for byte
    jsd_, tsd_ = jt2i.lora_state_dict(jl), tt2i.lora_state_dict(tl)
    assert list(tsd_) == list(jsd_)
    for k in jsd_:
        assert tsd_[k].dtype == jsd_[k].dtype and tsd_[k].shape == jsd_[k].shape
        assert tsd_[k].tobytes() == jsd_[k].tobytes(), k

    jf, tf = jt2i.apply_lora(jparams, jl, scale=2.0), tt2i.apply_lora(tparams, tl, scale=2.0)
    for site in tsites[:3] + tsites[-3:]:
        path = [int(p) if p.isdigit() else p for p in site.split(".")]
        want = np.asarray(jt2i._get(jf, path)["w"]).T
        got = tt2i._get(tf, path)["w"]
        assert got.requires_grad and fx.rel(got.detach().numpy(), want) <= 1e-6
    # untouched leaves are the UNet's own tensors: frozen, shared, not copied
    blk = tparams["blocks"][1]
    assert tf["blocks"][1]["proj_in"]["w"] is blk["proj_in"]["w"]
    assert tf["blocks"][1]["transformer_blocks"][0]["ff"]["w"] is \
        blk["transformer_blocks"][0]["ff"]["w"]
    assert not any(p.requires_grad for p in tparams.parameters())


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def test_trainer_matches_svi_tpu(unets, tmp_path):
    """Three steps of svi_tpu's trainer and the port's from the same adapters
    (svi_tpu's, through a PEFT file), latents and text context, the loss
    weighted by LOSS_WEIGHT: the losses and the adapters after the steps;
    the last step goes through `vae_encode_fn`. Then one step at weight 1
    (the losses), and the port's save_lora round trip."""
    from svi_tpu.schedulers.ddim import EnhancedDDIMScheduler as JDDIM
    from svi_tpu_torch.schedulers.ddim import EnhancedDDIMScheduler as TDDIM

    jparams, tparams = unets
    rng = np.random.default_rng(3)
    latents = rng.standard_normal(LATENT).astype(np.float32)
    emb = rng.standard_normal((1, 77, fx.TEXT_DIM)).astype(np.float32)
    kw = dict(learning_rate=1.0, lora_rank=4, lora_alpha=8.0, seed=5,
              lora_target_modules="to_q,to_k,to_v,to_out")
    jt = jt2i.T2ILoRATrainer(jparams, scheduler=_weighted(JDDIM, LOSS_WEIGHT), **kw)
    start = tmp_path / "start.safetensors"
    jt.save_lora(str(start))
    tt = tt2i.T2ILoRATrainer(tparams, scheduler=_weighted(TDDIM, LOSS_WEIGHT),
                             pretrained_lora_path=str(start), **kw)
    assert list(tt.lora) == list(jt.lora) and tt.scale == jt.scale == 2.0

    steps = [dict(latents=latents), dict(latents=latents),
             dict(batch_image=latents * 2, vae_encode_fn=lambda x: x / 2)]
    j_losses = [jt.training_step(prompt_emb=emb, **s) for s in steps]
    t_losses = [tt.training_step(prompt_emb=torch.from_numpy(emb), **s) for s in steps]
    assert all(np.isfinite(t_losses))
    np.testing.assert_allclose(t_losses, j_losses, rtol=T2I_REL)
    for name in ("A", "B"):
        got = np.concatenate([tt.lora[k][name].detach().numpy().ravel() for k in jt.lora])
        want = np.concatenate([np.asarray(jt.lora[k][name]).ravel() for k in jt.lora])
        assert fx.rel(got, want) <= T2I_REL, name
    moved = np.concatenate([np.asarray(ab["B"]).ravel() for ab in jt.lora.values()])
    assert np.abs(moved).max() > 1e-4  # the steps moved B off zero

    # weight 1 (AdamW's usual regime): the loss of one more step; the same
    # jitted step, its weight is an argument
    jt.scheduler.training_weight = tt.scheduler.training_weight = lambda t: 1.0
    np.testing.assert_allclose(tt.training_step(latents=latents, prompt_emb=emb),
                               jt.training_step(latents=latents, prompt_emb=emb), rtol=T2I_REL)

    saved = tmp_path / "port.safetensors"
    tt.save_lora(str(saved))
    back = tt2i.T2ILoRATrainer(tparams, pretrained_lora_path=str(saved), lora_rank=4)
    for k, ab in tt.lora.items():
        assert torch.equal(back.lora[k]["B"], ab["B"].detach())
        assert torch.equal(back.lora[k]["A"], ab["A"].detach())


def test_trainer_loads_only_its_sites(unets, tmp_path, capsys):
    """`pretrained_lora_path` loads the sites the trainer adapts and counts
    the rest as unexpected, in svi_tpu's message."""
    _, tparams = unets
    jl = _nonzero_lora(unets[0], rank=2)
    sd = jt2i.lora_state_dict(jl)
    sd["nowhere.lora_A.default.weight"] = np.zeros((2, 3), np.float32)
    sd["nowhere.lora_B.default.weight"] = np.zeros((3, 2), np.float32)
    path = tmp_path / "extra.safetensors"
    from svi_tpu_torch.utils.safetensors_io import save_file

    save_file({k: torch.from_numpy(v) for k, v in sd.items()}, str(path))
    tt = tt2i.T2ILoRATrainer(tparams, lora_rank=2, lora_target_modules="to_q",
                             pretrained_lora_path=str(path))
    n_q = sum(k.endswith("to_q") for k in jl)
    assert f"{2 * n_q} parameters are loaded" in capsys.readouterr().out
    assert len(tt.lora) == n_q and all(k.endswith("to_q") for k in tt.lora)


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------


def _write_dataset(root, image):
    from PIL import Image

    (root / "train").mkdir(parents=True)
    Image.fromarray(image).save(root / "train" / "img0.png")
    np.save(root / "train" / "img1.npy", image[::-1].copy())
    (root / "train" / "metadata.csv").write_text(
        "file_name,text\nimg0.png,a toy image\nimg1.npy,a flipped toy image\n")


@pytest.mark.parametrize("center_crop,random_flip,seed", [(True, False, 0), (False, True, 1),
                                                          (False, False, 2)])
def test_dataset_items_are_byte_equal(tmp_path, center_crop, random_flip, seed):
    """Items of the port's TextImageDataset against svi_tpu's, byte for byte:
    the rotation, Pillow's bilinear cover resize (the port's in numpy),
    centre or random crops and flips drawn in svi_tpu's order. The .npy row
    is compared with svi_tpu reading the same pixels as a PNG."""
    from PIL import Image

    image = np.random.default_rng(seed).integers(0, 255, (28, 40, 3), dtype=np.uint8)
    _write_dataset(tmp_path / "port", image)
    (tmp_path / "jax" / "train").mkdir(parents=True)
    Image.fromarray(image).save(tmp_path / "jax" / "train" / "img0.png")
    Image.fromarray(image[::-1].copy()).save(tmp_path / "jax" / "train" / "img1.png")
    (tmp_path / "jax" / "train" / "metadata.csv").write_text(
        "file_name,text\nimg0.png,a toy image\nimg1.png,a flipped toy image\n")
    kw = dict(steps_per_epoch=8, height=16, width=20, center_crop=center_crop,
              random_flip=random_flip, seed=seed)
    ours = tt2i.TextImageDataset(str(tmp_path / "port"), **kw)
    ref = jt2i.TextImageDataset(str(tmp_path / "jax"), **kw)
    assert len(ours) == len(ref) == 8
    for i in range(6):
        a, b = ours[i], ref[i]
        assert a["text"] == b["text"]
        assert a["image"].dtype == b["image"].dtype == np.float32
        assert a["image"].shape == b["image"].shape == (3, 16, 20)
        assert a["image"].tobytes() == b["image"].tobytes(), i
