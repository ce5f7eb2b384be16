"""The port's prompt path against svi_tpu's: the sentencepiece tokenizer
(ids and masks equal, over tests/test_sp_tokenizer.py's battery), Wan's
prompter (tokenize and encode_prompt), and the prompt-stream files.

The T5 v1.1 `spiece.model` vendored with each package stands in for umT5's,
which is not in the repository (as in tests/test_sp_tokenizer.py); its ids
are valid rows of umT5's embedding."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from svi_tpu.models import t5 as jt5
from svi_tpu.prompters import wan_prompter as jwp
from svi_tpu.prompters.sp_tokenizer import T5SpTokenizer as JaxTokenizer
from svi_tpu.prompters.sp_tokenizer import asset_path
from svi_tpu.utils.prompt_files import load_prompts_from_file as jax_load_prompts
from svi_tpu_torch.models import t5 as tt5
from svi_tpu_torch.prompters import wan_prompter as twp
from svi_tpu_torch.prompters.sp_tokenizer import T5SpTokenizer
from svi_tpu_torch.utils.prompt_files import DEFAULT_PROMPT, load_prompts_from_file
from test_sp_tokenizer import BATTERY

REPO = Path(__file__).resolve().parent.parent
PORT_T5 = str(REPO / "svi_tpu_torch" / "tokenizer_configs" / "t5")
# f32 encoder through 2 layers, summed in another order by each framework
F32_TOL = 1e-4


@pytest.fixture(scope="module")
def tokenizers():
    return (JaxTokenizer(asset_path("t5"), fast_pipeline=False),
            T5SpTokenizer(PORT_T5, fast_pipeline=False))


def test_the_vendored_model_is_the_same_file():
    for name in ("spiece.model", "added_tokens.json"):
        assert (Path(PORT_T5) / name).read_bytes() == (Path(asset_path("t5")) / name).read_bytes()


LONG = " ".join(BATTERY) * 3  # truncated: eos replaces the last kept id


@pytest.mark.parametrize("text", BATTERY + [LONG], ids=range(len(BATTERY) + 1))
def test_tokenizer_ids_and_mask_match_svi_tpu(tokenizers, text):
    jt, tt = tokenizers
    for max_length in (64, 16):
        want, got = jt([text], max_length=max_length), tt([text], max_length=max_length)
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])


def test_batch_pads_to_the_longest(tokenizers):
    jt, tt = tokenizers
    want, got = jt(BATTERY[:4]), tt(BATTERY[:4])  # no max_length: the longest text's width
    assert got["input_ids"].shape[1] == max(int(m.sum()) for m in got["attention_mask"])
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])


@pytest.mark.parametrize("text", ["  a &amp;amp; b\\n\\tc  ", "Ｆｕｌｌ  width　text", ""])
def test_cleaning_matches_svi_tpu(text):
    assert twp.basic_clean(text) == jwp.basic_clean(text)
    assert twp.whitespace_clean(text) == jwp.whitespace_clean(text)


def test_wan_prompter_tokenize_and_encode_match_svi_tpu(tmp_path):
    kw = dict(vocab=32128, dim=64, dim_attn=64, dim_ffn=96, num_heads=4, num_layers=2)
    import jax.numpy as jnp

    cfg_j = jt5.T5Config(dtype=jnp.float32, **kw)
    params = jt5.init_params(jax.random.PRNGKey(5), cfg_j)
    model = tt5.params_from_jax(jax.tree.map(np.asarray, params),
                                tt5.T5Config(dtype=torch.float32, **kw))
    jp = jwp.WanPrompter(tokenizer_path=asset_path("t5"), text_len=32)
    jp.fetch_models((params, cfg_j))
    tp = twp.WanPrompter(tokenizer_path=PORT_T5, text_len=32)
    tp.fetch_models(model)
    for prompt in ("A lone explorer   walks across\trolling hills.", BATTERY[2], LONG):
        jids, jmask = jp.tokenize(prompt)
        ids, mask = tp.tokenize(prompt)
        assert ids.dtype == jids.dtype == np.int32 and ids.shape == (1, 32)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(mask, jmask)
        with torch.inference_mode():
            got = tp.encode_prompt(prompt).numpy()
        want = np.asarray(jp.encode_prompt(prompt), np.float32)
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
        assert np.all(got[0, int(mask.sum()):] == 0)


def test_wan_prompter_needs_a_sentencepiece_model(tmp_path):
    with pytest.raises(FileNotFoundError, match="spiece.model"):
        twp.WanPrompter(tokenizer_path=str(tmp_path))
    with pytest.raises(RuntimeError, match="tokenizer"):
        twp.WanPrompter().tokenize("a cat")


@pytest.mark.parametrize("sample", ["shot", "film", "tom"])
def test_prompt_files_match_svi_tpu(sample):
    path = str(REPO / "data" / "toy_test" / sample / "prompt.txt")
    got = load_prompts_from_file(path)
    assert got == jax_load_prompts(path) and len(got) >= 2 and all(got)


def test_prompt_file_fallbacks_match_svi_tpu(tmp_path):
    cases = {"lines.txt": "# a comment\nfirst prompt\n\nsecond prompt\n",
             "nested.txt": 'x = 1\nprompts = ["a [b] c", "d"]\nprompts = ["ignored"]\n',
             "bad.txt": "prompts = [unclosed, 'x'\n", "empty.txt": "\n# only a comment\n"}
    for name, text in cases.items():
        (tmp_path / name).write_text(text)
        path = str(tmp_path / name)
        assert load_prompts_from_file(path) == jax_load_prompts(path), name
    assert load_prompts_from_file(str(tmp_path / "missing.txt")) == [DEFAULT_PROMPT]
