"""The port's trainer variants against svi_tpu's, on the CPU: pose training
(SVI-Dance), customtalk training and audio conditioning (SVI-Talk), LoRA on
an int4_w4a8 or w8a8 base (the straight-through backward), the
save-attention and host-offload remat variants, the LoRA export (each
package reads the other's file) and a resumed run.

Weights come from svi_tpu's `init_params` (and its quantizers) and are
carried across with the port's `params_from_jax`; inputs from
np.random.default_rng(seed); both trainers run 3 steps on one batch with
the same host RNG draws, as tests/test_torch_training.py does for the plain
LoRA trainer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svi_tpu.models import wan_dit as jdit
from svi_tpu.training import ErrorRecyclingTrainer as JTrainer
from svi_tpu.training import TrainerConfig as JConfig
from svi_tpu_torch.models import pose_embedding as tpose
from svi_tpu_torch.models import wan_dit as tdit
from svi_tpu_torch.ops import attention as tattn
from svi_tpu_torch.training import ErrorRecyclingTrainer as TTrainer
from svi_tpu_torch.training import TrainerConfig as TConfig
from svi_tpu_torch.training import lora as tlora
from svi_tpu_torch.training import trainer as ttrainer

# f32 I2V DiTs of 2 blocks on a 2 x 8 x 8 latent grid (32 tokens); the
# quantized base has one head of 128, so that int4 groups of 16 and the W4A8
# linear take every linear of 1024 weights or more (as tests/test_torch_quant.py)
BASE = dict(in_dim=12, out_dim=4, text_dim=48, freq_dim=32, num_layers=2, has_image_input=True,
            clip_feature_dim=40)
AUDIO = dict(audio_hidden_dim=32, audio_context_tokens=4)
VARIANTS = {
    # name: (DiT config, trainer config, quantize mode)
    "pose": (dict(dim=64, ffn_dim=128, num_heads=2),
             dict(train_pose=True, pose_drop_prob1=0.3, cond_drop_prob=0.3), None),
    "customtalk": (dict(dim=64, ffn_dim=128, num_heads=2, enable_customtalk=True, **AUDIO),
                   dict(train_architecture="customtalk", audio_drop_prob=0.3), None),
    "customtalk_pose": (dict(dim=64, ffn_dim=128, num_heads=2, enable_customtalk=True, **AUDIO),
                        dict(train_architecture="customtalk", train_pose=True,
                             audio_drop_prob=0.3), None),
    "audio": (dict(dim=64, ffn_dim=128, num_heads=2, enable_multitalk=True, **AUDIO),
              dict(audio_drop_prob=0.3), None),
    "int4_w4a8": (dict(dim=128, ffn_dim=256, num_heads=1), {}, "int4_w4a8"),
    "w8a8": (dict(dim=128, ffn_dim=256, num_heads=1), {}, "w8a8"),
}
TRAIN_KW = dict(lora_rank=4, lora_alpha=4.0, buffer_warmup_iter=2, error_buffer_k=8,
                num_grids=10, seed=0)
MIN_SIZE, GROUP = 1024, 16

# f32 on both sides, as tests/test_torch_training.py: the loss and the
# gradient norm differ by the order of f32 sums; AdamW's first steps move a
# parameter by about lr * g / (|g| + eps), so one whose gradient is near eps
# is sensitive to that order: a quarter of one step (lr = 1e-4) bounds the
# parameters, a wrong gradient sign moves one by two steps.
LOSS_RTOL = 1e-4
PARAM_ATOL = 2.5e-5
ERROR_ATOL = 1e-4
# The quantized bases round every linear's activations to int8 on both
# sides: a value computed in another order can land one int8 level apart
# (about 1% of its row's largest value), and that moves the loss and the
# gradients by up to 5e-3 of their size (tests/test_torch_quant.py's forward
# bound). Adam's normalised step turns a gradient component within that of
# zero into a step of either sign, so a parameter may differ by two steps.
QUANT_LOSS_RTOL = 5e-3
QUANT_PARAM_ATOL = 2.5e-4
QUANT_ERROR_ATOL = 2e-2


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _trainers(variant, use_remat=True, **extra):
    dit_kw, train_kw, quant = VARIANTS[variant]
    cj = jdit.WanDiTConfig(dtype=jnp.float32, **BASE, **dit_kw)
    ct = tdit.WanDiTConfig(dtype=torch.float32, **BASE, **dit_kw)
    params = jdit.init_params(jax.random.PRNGKey(0), cj)
    if quant:
        params = jdit.quantize_params_for_inference(params, quant, min_size=MIN_SIZE,
                                                    group=GROUP)
    kw = dict(TRAIN_KW, use_gradient_checkpointing=use_remat, **train_kw, **extra)
    jt = JTrainer(params, cj, JConfig(**kw))
    if "lora" in jt.trainable:
        jt.lora = jax.tree.map(lambda x: x + 0.02, jt.lora)  # B non-zero: every A moves
    tt = TTrainer(tdit.params_from_jax(_host(params), ct), TConfig(**kw), device="cpu")
    if "lora" in jt.trainable:
        tt.lora = tlora.params_from_jax(_host(jt.lora), device="cpu")
    if "pose" in jt.trainable:
        tt.pose_params = tpose.params_from_jax(_host(jt.trainable["pose"]))
    jt.opt_state = jt.optimizer.init(jt.trainable)
    # the same banked errors in every grid, so that injection happens
    data = np.random.default_rng(3)
    for t in jt.buffers.grid_timesteps:
        for add in ("add_latent_error", "add_y_error"):
            err = data.standard_normal((1, 4, 2, 8, 8)).astype(np.float32)
            getattr(jt.buffers, add)(err, float(t))
            getattr(tt.buffers, add)(err, float(t))
    return jt, tt


def _batch(variant):
    rng = np.random.default_rng(1)
    batch = dict(latents=rng.standard_normal((1, 4, 2, 8, 8)).astype(np.float32),
                 context=rng.standard_normal((1, 7, 48)).astype(np.float32),
                 y=rng.standard_normal((1, 8, 2, 8, 8)).astype(np.float32),
                 clip_feature=rng.standard_normal((1, 5, 40)).astype(np.float32))
    if "pose" in variant:
        # 5 frames of 64 x 64: with the 3-frame prefix the conv stack gives
        # 2 x 4 x 4 tokens, the latent grid's
        batch["pose"] = rng.uniform(0, 255, (1, 3, 5, 64, 64)).astype(np.float32)
    if variant.startswith(("customtalk", "audio")):
        batch["audio_tuple"] = (rng.standard_normal((1, 1, 5, 12, 32)).astype(np.float32),
                                rng.standard_normal((1, 1, 8, 12, 32)).astype(np.float32))
    return batch


def _jax_trainables(jt) -> dict:
    """svi_tpu's trainables under the port's `named_trainables` names, in
    the port's layouts."""
    out = {}
    for kind, tree in jt.trainable.items():
        tree = _host(tree)
        if kind == "lora":
            blocks = tlora.params_from_jax(tree, device="cpu")
            out.update({f"lora.{k}": v.detach().numpy()
                        for k, v in blocks.named_parameters()})
        elif kind == "pose":
            out.update({f"pose.{k}": v.detach().numpy()
                        for k, v in tpose.params_from_jax(tree).named_parameters()})
        else:  # customtalk: per block, per FFN, per linear: w (in, out) -> (out, in), b
            for blk in range(jt.dit_cfg.num_layers):
                for name in ttrainer.CUSTOMTALK_FFNS:
                    for idx in ("0", "2"):
                        leaf = tree[name][idx]
                        key = f"customtalk.blocks.{blk}.{name}.{idx}"
                        out[f"{key}.w"] = leaf["w"][blk].T
                        out[f"{key}.b"] = leaf["b"][blk]
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_trainer_three_steps_match_jax(variant):
    """Losses, grad norms, every trainable after each step and the banked
    errors, with the pose / condition / audio dropout draws in the JAX
    package's order (their probabilities raised so that 3 steps draw both
    ways)."""
    quant = VARIANTS[variant][2] is not None
    loss_rtol = QUANT_LOSS_RTOL if quant else LOSS_RTOL
    atol = QUANT_PARAM_ATOL if quant else PARAM_ATOL
    jt, tt = _trainers(variant)
    batch = _batch(variant)
    for _ in range(3):
        mj = jt.training_step(**batch)
        mt = tt.training_step(**batch)
        for key in ("timestep", "grid", "used_clean_input", "warmup", "buffer_latent_total",
                    "buffer_y_total"):
            assert mt[key] == mj[key], key
        np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=loss_rtol)
        np.testing.assert_allclose(mt["grad_norm"], mj["grad_norm"], rtol=loss_rtol)
        want = _jax_trainables(jt)
        got = tt.named_trainables()
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].detach().numpy(), v, atol=atol, rtol=0, err_msg=k)
    assert tt.rng.getstate() == jt.rng.getstate()
    for store in ("latent_error_buffer", "y_error_buffer"):
        got, want = getattr(tt.buffers, store), getattr(jt.buffers, store)
        for g in want:
            assert len(got[g]) == len(want[g])
            for a, b in zip(got[g], want[g]):
                np.testing.assert_allclose(a, b, atol=QUANT_ERROR_ATOL if quant else ERROR_ATOL,
                                           rtol=0)


def test_only_the_variant_trainables_train():
    """customtalk: the FFNs alone of the DiT take gradients (the rest stays
    frozen); every trainable is in the one optimizer; a quantized customtalk
    FFN and int8 attention are refused; a mesh is accepted, and sharded
    optimizer state without one keeps that one optimizer (as in the JAX
    package)."""
    _, tt = _trainers("customtalk_pose")
    trainables = set(map(id, tt.named_trainables().values()))
    assert trainables == set(map(id, tt.optimizer.params))
    for name, p in tt.dit.named_parameters():
        assert p.requires_grad == ("customtalk" in name), name
    assert tt.lora is None and tt.pose_params is not None
    cfg = tdit.WanDiTConfig(dtype=torch.float32, **BASE, **VARIANTS["customtalk"][0])
    dit = tdit.init_params(cfg, device="cpu")
    quantized = tdit.quantize_params_for_inference(dit, "int8", min_size=16, group=GROUP)
    with pytest.raises(ValueError, match="quantized"):
        TTrainer(quantized, TConfig(train_architecture="customtalk"), device="cpu")
    assert TTrainer(dit, device="cpu", mesh=object()).mesh is not None
    unsharded = TTrainer(dit, TConfig(train_architecture="customtalk",
                                      shard_optimizer_state=True), device="cpu")
    assert unsharded.optimizer.owner is None
    assert set(map(id, unsharded.optimizer.opt.param_groups[0]["params"])) == set(
        map(id, unsharded.named_trainables().values()))
    with pytest.raises(ValueError, match="attention_quant"):
        TTrainer(tdit.WanDiT(dataclasses.replace(cfg, attention_quant="qk8"), dit.tree()),
                 device="cpu")


def _reference_calls(monkeypatch):
    """Counts the plain attention forward's calls (the CPU's K1 and K2)."""
    calls = {"n": 0}
    plain = tattn._flash_fwd_reference

    def counted(*args, **kwargs):
        calls["n"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(tattn, "_flash_fwd_reference", counted)
    return calls


class _CountingSaveOnCpu(torch.autograd.graph.save_on_cpu):
    """save_on_cpu that records the shapes of the tensors it packs."""

    packed: list = []

    def __init__(self, pin_memory=False, device_type="cuda"):
        super().__init__(pin_memory, device_type)
        pack = self.pack_hook

        def counted(t):
            _CountingSaveOnCpu.packed.append(tuple(t.shape))
            return pack(t)

        self.pack_hook = counted


@pytest.mark.parametrize("variant", ["pose", "customtalk"])
@pytest.mark.parametrize("group", [1, 2])
def test_save_attention_and_offload_give_plain_gradients(variant, group, monkeypatch):
    """save_attention and offload_carries, per block and in groups, with the
    pose condition and the customtalk (tokens, condition) carry: the same
    gradients as plain remat, bit for bit (the same operations on the same
    values). Per block, save_attention skips the recompute of every block's
    self-attention forward; offload_carries packs each block's carry (and
    the customtalk condition) through save_on_cpu."""
    dit_kw, _, _ = VARIANTS[variant]
    cfg = tdit.WanDiTConfig(dtype=torch.float32, **dict(BASE, num_layers=4), **dit_kw)
    dit = tdit.init_params(cfg, seed=1, device="cpu")
    lora = tlora.init_lora_params(cfg, rank=4, generator=torch.Generator().manual_seed(1),
                                  device="cpu")
    with torch.no_grad():
        for p in lora.parameters():
            p.add_(0.01)
    pose = tpose.init_params(cfg.dim, seed=2, device="cpu").requires_grad_(True)
    batch = {k: v if isinstance(v, tuple) else torch.from_numpy(v)
             for k, v in _batch(variant).items()}
    audio = batch.get("audio_tuple")
    if audio is not None:
        audio = tuple(torch.from_numpy(a) for a in audio)
    calls = _reference_calls(monkeypatch)
    monkeypatch.setattr(torch.autograd.graph, "save_on_cpu", _CountingSaveOnCpu)
    params = list(lora.parameters()) + (list(pose.parameters()) if "pose" in batch else [])
    runs = {}
    for name, kw in (("plain", {}), ("save", dict(save_attention=True)),
                     ("offload", dict(offload_carries=True)),
                     ("both", dict(save_attention=True, offload_carries=True))):
        calls["n"] = 0
        _CountingSaveOnCpu.packed = []
        cond = pose(batch["pose"]) if "pose" in batch else None
        out = dit(batch["latents"], torch.tensor([300.0]), batch["context"],
                  batch["clip_feature"], batch["y"], add_condition=cond, lora=lora,
                  audio_embed_tuple=audio, use_remat=True, remat_granularity=group, **kw)
        grads = torch.autograd.grad(out.square().mean(), params)
        runs[name] = (grads, calls["n"], list(_CountingSaveOnCpu.packed))
    for name in ("save", "offload", "both"):
        for a, b in zip(runs["plain"][0], runs[name][0]):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    attn_per_forward = 3 * cfg.num_layers  # self, text cross, image cross
    assert runs["plain"][1] == 2 * attn_per_forward if group == 1 else runs["plain"][1] > 0
    if group == 1:
        assert runs["save"][1] == runs["both"][1] == 2 * attn_per_forward - cfg.num_layers
    carries = 2 if variant == "customtalk" else 1
    tokens = (1, 32, cfg.dim)
    assert runs["plain"][2] == runs["save"][2] == []
    n_saved = cfg.num_layers // group if group > 1 else cfg.num_layers
    for name in ("offload", "both"):
        assert runs[name][2].count(tokens) == carries * n_saved, runs[name][2]


def _lora_and_pose_trainers():
    jt, tt = _trainers("pose")
    jt.lora = jax.tree.map(lambda x: x * 1.5 + 0.01, jt.lora)
    tt.lora = tlora.params_from_jax(_host(jt.lora), device="cpu")
    return jt, tt


def test_lora_export_matches_jax_and_each_package_reads_the_other(tmp_path):
    """LoRA + pose (SVI-Dance) and customtalk + pose files: the port's and
    the JAX package's have the same keys, shapes and values (f32; written
    from the same trainables), side modules included. One quirk of the JAX
    package: it hands safetensors.numpy the pose conv weights as transposed
    views, and this box's safetensors writes a view's memory order, so its
    file holds them scrambled; there the port's file is held to the array
    the JAX package meant to write. The JAX trainer loads the port's file to
    the port's trainables; the port's trainer loads the JAX file's adapters."""
    from safetensors.numpy import load_file as np_load

    side = {"randomref_embedding_pose.0.weight": np.arange(6, dtype=np.float32).reshape(2, 3)}
    for variant, (jt, tt) in (("pose", _lora_and_pose_trainers()),
                              ("customtalk_pose", _trainers("customtalk_pose"))):
        jt.save_lora_safetensors(str(tmp_path / f"{variant}_jax.safetensors"), side_modules=side)
        tt.save_lora_safetensors(str(tmp_path / f"{variant}_port.safetensors"), side_modules=side)
        want = np_load(str(tmp_path / f"{variant}_jax.safetensors"))
        got = np_load(str(tmp_path / f"{variant}_port.safetensors"))
        assert got.keys() == want.keys() and any("dwpose_embedding" in k for k in got)
        pose_w = {f"dwpose_embedding.{2 * i}.weight": np.asarray(conv["w"], np.float32)
                  for i, conv in enumerate(jt.trainable["pose"])}
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float32 and got[k].shape == want[k].shape
            if k in pose_w and not np.array_equal(got[k], want[k]):
                # the JAX file's bytes are the (kt, kh, kw, in, out) array's
                np.testing.assert_array_equal(want[k].reshape(-1), pose_w[k].reshape(-1))
                np.testing.assert_array_equal(got[k], np.transpose(pose_w[k], (4, 3, 0, 1, 2)))
                continue
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if variant != "pose":
            continue
        mine = {k: v.detach().numpy() for k, v in tt.named_trainables().items()}
        jt2, tt2 = _trainers("pose")
        jt2.load_lora_safetensors(str(tmp_path / "pose_port.safetensors"))
        theirs = _jax_trainables(jt2)
        assert theirs.keys() == mine.keys()
        for k, v in mine.items():
            np.testing.assert_array_equal(theirs[k], v, err_msg=f"the JAX trainer read {k}")
        tt2.load_lora_safetensors(str(tmp_path / "pose_jax.safetensors"))
        for k, v in tt2.named_trainables().items():
            if k.startswith("lora."):
                np.testing.assert_array_equal(v.detach().numpy(), mine[k],
                                              err_msg=f"the port read {k}")


def test_checkpoint_restore_then_step_equals_uninterrupted(tmp_path):
    """Two steps, save_checkpoint, a fresh trainer restore_checkpoint, one
    more step: the same host draws, loss, trainables, optimizer state and
    banked errors as a third step of the uninterrupted run."""
    _, tt = _trainers("pose")
    batch = _batch("pose")
    for _ in range(2):
        tt.training_step(**batch)
    tt.save_checkpoint(str(tmp_path / "ckpt"))
    want = tt.training_step(**batch)

    _, fresh = _trainers("pose")
    fresh.restore_checkpoint(str(tmp_path / "ckpt"))
    assert fresh.iteration_count == 2
    got = fresh.training_step(**batch)
    assert got == want
    assert fresh.rng.getstate() == tt.rng.getstate()
    for k, p in tt.named_trainables().items():
        torch.testing.assert_close(fresh.named_trainables()[k], p, atol=0, rtol=0)
    for a, b in zip(fresh.optimizer.opt.state.values(), tt.optimizer.opt.state.values()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(a[key], b[key], atol=0, rtol=0)
    for store in ("latent_error_buffer", "y_error_buffer"):
        for g, errs in getattr(tt.buffers, store).items():
            for a, b in zip(getattr(fresh.buffers, store)[g], errs):
                np.testing.assert_array_equal(a, b)
    # a trainer of another configuration refuses the checkpoint
    _, other = _trainers("audio")
    with pytest.raises(ValueError, match="trainables differ"):
        other.restore_checkpoint(str(tmp_path / "ckpt"))


def test_quantized_base_unpacks_once_for_each_linear_that_needs_dx(monkeypatch):
    """A LoRA step on the int4_w4a8 base runs every quantized linear through
    w4a8_linear in the forward and again in the per-block recompute, and
    K3 (unpack_requant_int4) once in the straight-through backward of each
    linear whose input needs a gradient: 2 blocks x 12 quantized linears
    and the prelude's 6 and the head, forward (31) + recompute (24) = 55
    W4A8 calls a step; K3 for block 0's self o, cross q, cross o, ffn.0,
    ffn.2 (its self q, k, v read the patch tokens), block 1's self q, k,
    v, o, cross q, o, ffn.0, ffn.2 (no block's cross k, v, k_img, v_img:
    they read the context), and the head = 14 a step. chip_smoke.py counts
    the card's launches by the same rule (`k3_per_step`)."""
    calls = {"k3": 0, "w4a8": 0}
    k3, w4a8 = tdit.unpack_requant_int4, tdit.w4a8_linear

    def counted_k3(*args):
        calls["k3"] += 1
        return k3(*args)

    def counted_w4a8(*args):
        calls["w4a8"] += 1
        return w4a8(*args)

    monkeypatch.setattr(tdit, "unpack_requant_int4", counted_k3)
    monkeypatch.setattr(tdit, "w4a8_linear", counted_w4a8)
    dit_kw, _, quant = VARIANTS["int4_w4a8"]
    cfg = tdit.WanDiTConfig(dtype=torch.float32, **BASE, **dit_kw)
    dit = tdit.quantize_params_for_inference(tdit.init_params(cfg, device="cpu"), quant,
                                             min_size=MIN_SIZE, group=GROUP)
    names = [n for n, _ in dit.named_parameters() if n.endswith("w_q4")]
    assert len(names) == 31 and sum(n.startswith("blocks.") for n in names) == 24
    trainer = TTrainer(dit, TConfig(**TRAIN_KW), device="cpu")
    for step in range(1, 3):
        trainer.training_step(**_batch("int4_w4a8"))
        assert calls == {"k3": 14 * step, "w4a8": 55 * step}
