"""The port's tokenizers (``quant_gemm_tpu_torch/models/tokenizer.py``)
against the JAX package's, on the CPU.

Tolerance: none, the ids, splits and rendered text are equal.  The
vocabularies are those of ``tests/test_tokenizer.py`` and the one
embedded in ``tests/golden/tiny_llama_q4km.gguf`` (byte-level BPE trained
by HuggingFace ``tokenizers``).  The pretokenizer property test holds the
port's ``re`` split, which needs no ``regex`` module, to JAX's ``regex``
split of the same ``tokenizer.ggml.pre`` over arbitrary unicode text.
"""

import pathlib
import subprocess
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import test_tokenizer as jtests
from quant_gemm_tpu.formats.gguf_file import GGUFFile
from quant_gemm_tpu.models import tokenizer as jt
from quant_gemm_tpu_torch.models import tokenizer as tt

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "golden" / "tiny_llama_q4km.gguf"
PRES = ("gpt2", "llama3", "qwen2")
TEXTS = ["hello world", "  leading spaces", "trailing space ",
         "tabs\t\tand\nnewlines\r\n\r\n", "a  b   c    d",
         "Grüße aus München, naïve café", "日本語のテキストです。",
         "числа: один два три", "emoji 🤖🚀 done", "123 456.789 1234567",
         "can't won't shouldn't it's I'LL WE'VE 'S 'ſ", "UPPER lower MiXeD",
         "x y　z\x1c\x1d \x1e\x1f w", "೜\U00016d40 letters",
         "¹²³ ½ Ⅻ ٣٤", "", " ", "\n\n\n", "'", "a'b 'tis"]


def _spm_md(tok):
    return {"tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": tok.tokens,
            "tokenizer.ggml.scores": [float(s) for s in tok.scores],
            "tokenizer.ggml.token_type": [int(t) for t in tok.token_types],
            "tokenizer.ggml.bos_token_id": 1,
            "tokenizer.ggml.eos_token_id": 2}


def _bpe_md(pre):
    tok = jtests._bpe_vocab()
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": pre,
            "tokenizer.ggml.tokens": tok.tokens,
            "tokenizer.ggml.merges": ["Ġ t", "h e", "Ġt he", "a b", "Ġ ab",
                                      "l l", "he ll", "hell o",
                                      "Ġthe Ġab"],
            "tokenizer.ggml.token_type": tok.token_types,
            "tokenizer.ggml.bos_token_id": 0}


@pytest.fixture(scope="module")
def fixture_md():
    return GGUFFile(str(FIXTURE)).metadata


def test_port_tokenizer_imports_no_regex():
    code = ("import sys; import quant_gemm_tpu_torch.models.tokenizer as t; "
            "t.pretokenizer('qwen2'); t.pretokenizer('llama3'); "
            "assert 'regex' not in sys.modules, 'regex imported'")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("text", ["abc", "the ab", "a€b", "ab c the abc",
                                  "  the   ab ", "été abc"])
def test_spm_ids_and_text_equal_jax(text):
    tok_j = jt.SPMTokenizer.from_gguf(_spm_md(jtests._vocab()))
    tok_t = tt.tokenizer_from_gguf(_spm_md(jtests._vocab()))
    assert isinstance(tok_t, tt.SPMTokenizer)
    for bos in (True, False):
        ids = tok_t.encode(text, add_bos=bos)
        assert ids == tok_j.encode(text, add_bos=bos)
        assert tok_t.decode(ids) == tok_j.decode(ids)


@pytest.mark.parametrize("pre", PRES + ("llama-bpe", "default", "olmo"))
def test_bpe_ids_and_text_equal_jax(pre):
    tok_j = jt.tokenizer_from_gguf(_bpe_md(pre))
    tok_t = tt.tokenizer_from_gguf(_bpe_md(pre))
    assert isinstance(tok_t, tt.BPETokenizer)
    for text in TEXTS:
        ids = tok_t.encode(text)
        assert ids == tok_j.encode(text), text
        assert tok_t.decode(ids) == tok_j.decode(ids) == text


def test_fixture_ids_equal_jax_and_pinned(fixture_md):
    tok_j = jt.tokenizer_from_gguf(fixture_md)
    tok_t = tt.tokenizer_from_gguf(fixture_md)
    assert tok_t.encode("hello world") == [0, 262, 312, 311, 292]
    for text in TEXTS:
        ids = tok_t.encode(text)
        assert ids == tok_j.encode(text), text
        assert tok_t.decode(ids) == tok_j.decode(ids)


def test_unknown_pre_and_model_raise():
    with pytest.raises(ValueError, match="pretokenizer"):
        tt.tokenizer_from_gguf(_bpe_md("no-such-pre"))
    with pytest.raises(ValueError, match="unknown"):
        tt.tokenizer_from_gguf({"tokenizer.ggml.model": "rwkv"})
    with pytest.raises(ValueError, match="SPM"):
        tt.SPMTokenizer.from_gguf({"tokenizer.ggml.model": "gpt2",
                                   "tokenizer.ggml.tokens": ["a"]})


@pytest.mark.parametrize("pre", PRES)
@settings(max_examples=300, deadline=None)
@given(text=st.text(max_size=60))
def test_split_equals_jax_regex_on_unicode_text(pre, text):
    import regex

    want = regex.compile(jt._PRE_PATTERNS[pre]).findall(text)
    assert tt.pretokenizer(pre).findall(text) == want


@pytest.mark.parametrize("pre", PRES)
@settings(max_examples=200, deadline=None)
@given(text=st.text(alphabet=st.sampled_from(
    list(" \t\n\r\x0b\x0c\x1c\x1d\x85\xa0 　'sStTdDmMlLeErRvV"
         "ſ0123456789²٣aé一!?.,-_\U0001f600")),
    max_size=40))
def test_split_equals_jax_regex_on_edge_alphabet(pre, text):
    """Dense in the cases where the classes or the contractions could
    part: whitespace \\s and str.isspace disagree on (U+001C, U+001D),
    case-folded contractions (the long s), digit runs, non-Latin
    letters and numbers."""
    import regex

    want = regex.compile(jt._PRE_PATTERNS[pre]).findall(text)
    assert tt.pretokenizer(pre).findall(text) == want


def test_classes_cover_the_regex_module_everywhere():
    """The port's letter, number and whitespace classes hold exactly the
    code points the ``regex`` module's \\p{L}, \\p{N} and \\s match."""
    import re

    import regex

    c = tt._classes()
    for key, pat in (("L", r"\p{L}"), ("N", r"\p{N}"), ("S", r"\s")):
        mine = re.compile(f"[{c[key]}]")
        theirs = regex.compile(pat)
        text = "".join(chr(cp) for cp in range(0x110000)
                       if not 0xD800 <= cp <= 0xDFFF)
        assert mine.findall(text) == theirs.findall(text), key


def test_classes_are_built_for_the_recorded_unicode_versions():
    """The port's classes are this Python's ``unicodedata`` categories
    plus tables of what ``regex``'s classes held beyond them: a Python of
    another Unicode version fails here rather than split otherwise.  The
    ``regex`` module names no Unicode version: a letter first assigned in
    17.0 (Tai Yo, U+1E6C0) is one to it, and the test above holds it to
    the tables on every code point."""
    import unicodedata

    import regex

    assert unicodedata.unidata_version == tt.UNIDATA_VERSION == "15.0.0"
    assert tt.REGEX_UNICODE_VERSION == "17.0.0"
    assert unicodedata.category("\U0001e6c0") == "Cn"
    assert regex.fullmatch(r"\p{L}", "\U0001e6c0")


def test_render_chat_equals_jax(fixture_md):
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hi"},
            {"role": "assistant", "content": "hello"},
            {"role": "user", "content": "and now?"}]
    for gen in (True, False):
        assert tt.render_chat(fixture_md, msgs, gen) == \
            jt.render_chat(fixture_md, msgs, gen)
    md = {"tokenizer.chat_template": "{{ bos_token }}{{ eos_token }}",
          "tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>"],
          "tokenizer.ggml.bos_token_id": 1,
          "tokenizer.ggml.eos_token_id": 2}
    assert tt.render_chat(md, []) == jt.render_chat(md, []) == "<s></s>"
    with pytest.raises(ValueError, match="chat_template"):
        tt.render_chat({}, [])


def test_encode_with_specials_equals_jax(fixture_md):
    tok_j = jt.tokenizer_from_gguf(fixture_md)
    tok_t = tt.tokenizer_from_gguf(fixture_md)
    text = tt.render_chat(fixture_md, [{"role": "user", "content": "hi you"}])
    for s in (text, "<|user|>\nhi<|eot|>", "plain text", "<|eot|><|eot|>x"):
        assert tt.encode_with_specials(tok_t, s) == \
            jt.encode_with_specials(tok_j, s)
    spm_t = tt.tokenizer_from_gguf(_spm_md(jtests._vocab()))
    spm_j = jt.tokenizer_from_gguf(_spm_md(jtests._vocab()))
    for s in ("<s>ab</s><s>the", "the <unk> ab"):
        assert tt.encode_with_specials(spm_t, s) == \
            jt.encode_with_specials(spm_j, s)
