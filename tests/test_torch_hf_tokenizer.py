"""The port's standard-library HfTokenizer (tokenizer_json.py) against the
JAX package's, which wraps the ``tokenizers`` library, on tokenizers of
the shapes Llama-family checkpoints ship, each trained here with the
library's trainers on an in-test corpus: Llama 3 (byte-level BPE with
ignore_merges, a Split on Llama 3's regex, a BOS template), Qwen2.5 (NFC,
single digits, no BOS), Llama 2 / Mistral (byte fallback and fused unk,
either the Prepend/Replace normalizer or a Metaspace pre-tokenizer) and
the reference's word-level test tokenizer. Ids with and without special
tokens, decode with and without skipping, the EOS ids, the vocab size
and DecodeStream's pieces are held equal, on fixed texts and a
hypothesis search; an unsupported component raises ValueError naming
it."""
import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from tokenizers import (
    AddedToken,
    Regex,
    Tokenizer,
    decoders,
    models,
    normalizers,
    pre_tokenizers,
    processors,
    trainers,
)

from dynamo_tpu import tokenizer as rtok
from dynamo_tpu_torch import tokenizer as ptok
from dynamo_tpu_torch import tokenizer_json as tj

LLAMA3_SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>",
                   "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>"]
QWEN_SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
QWEN_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

CORPUS = [
    "The quick brown fox jumps over the lazy dog. It's 2024, isn't it?",
    "def main(argv):\n    return sum(int(x) for x in argv[1:]) * 31337\n",
    "Dynamo serves large language models: prefill, decode, KV routing.",
    "Héllo wörld — naïve café, straße, Ærøskøbing; ¿qué tal? ¡bien!",
    "東京は日本の首都です。今日は良い天気ですね。我喜欢学习。",
    "Emoji 😀🚀🎉 and flags 🇫🇷, numbers 1234567890 and 3.14159.",
    "  indented   text\twith\ttabs\r\nand CRLF lines\n\n\nblank lines",
    "WE'LL SEE, THEY'VE GONE, I'M HERE, YOU'D KNOW, she's right.",
    "Combining: é ä ñ — and Hangul 한국어 텍스트.",
    "JSON: {\"role\": \"user\", \"content\": \"hi\"} <tag attr='1'/>",
] * 8

TEXTS = [
    "", " ", "a", "Hello world", "  leading spaces and   runs",
    "trailing space ", "numbers 123 and 456789 mixed2with words",
    "punct!!! ... --- (mixed) [brackets] {braces}",
    "don't we'll they've I'm you're he'd it's WE'LL I'D",
    "tabs\tand\nnewlines\r\nmixed \n\n double", "café naïve",
    "été NFC vs NFD: é é",
    "emoji \U0001f600\U0001f680 ok 🇯🇵", "日本語のテキスト、中文。",
    "<|begin_of_text|>hi<|eot_id|>", "x<|im_start|>user\nhi<|im_end|>",
    "<s> and </s> inside <unk> text", "\x1c\x1d\x85​﻿　end",
    "zzzqqq ȸȹ ꙮ unknown letters",
]


def _save(tok: Tokenizer, d, eos, bos=None, merges_as_strings=False):
    spec = json.loads(tok.to_str())
    if merges_as_strings:
        spec["model"]["merges"] = [
            m if isinstance(m, str) else " ".join(m)
            for m in spec["model"]["merges"]]
    d.mkdir(parents=True, exist_ok=True)
    (d / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False))
    cfg = {"eos_token_id": eos}
    if bos is not None:
        cfg["bos_token_id"] = bos
    (d / "config.json").write_text(json.dumps(cfg))
    return str(d)


def _byte_level_bpe(pattern, specials, normalizer=None, bos=None):
    tok = Tokenizer(models.BPE(ignore_merges=True))
    if normalizer is not None:
        tok.normalizer = normalizer
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(pattern), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=700, min_frequency=1, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        special_tokens=specials)
    tok.train_from_iterator(CORPUS, trainer)
    post = [processors.ByteLevel(trim_offsets=False)]
    if bos is not None:
        post.append(processors.TemplateProcessing(
            single=f"{bos} $A", pair=f"{bos} $A {bos} $B",
            special_tokens=[(bos, tok.token_to_id(bos))]))
    tok.post_processor = processors.Sequence(post)
    return tok


def _sentencepiece_bpe(metaspace: bool, split: bool = False):
    """A Llama 2 / Mistral shaped BPE: <unk> <s> </s>, the 256 byte
    tokens, then merges learned on the corpus."""
    base = Tokenizer(models.BPE())
    base.normalizer = normalizers.Sequence([
        normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    base.pre_tokenizer = pre_tokenizers.Metaspace(
        replacement="▁", prepend_scheme="never", split=True)
    trainer = trainers.BpeTrainer(vocab_size=500, min_frequency=2,
                                  show_progress=False)
    base.train_from_iterator(CORPUS, trainer)
    trained = json.loads(base.to_str())["model"]
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for t in sorted(trained["vocab"], key=trained["vocab"].get):
        vocab.setdefault(t, len(vocab))
    spec = json.loads(Tokenizer(models.BPE()).to_str())
    spec["model"].update(vocab=vocab, merges=trained["merges"],
                         unk_token="<unk>", byte_fallback=True,
                         fuse_unk=True)
    spec["added_tokens"] = [
        {"id": i, "content": c, "single_word": False, "lstrip": False,
         "rstrip": False, "normalized": False, "special": True}
        for c, i in (("<unk>", 0), ("<s>", 1), ("</s>", 2))]
    spec["post_processor"] = json.loads(processors.TemplateProcessing(
        single="<s> $A", pair="<s> $A <s> $B",
        special_tokens=[("<s>", 1)]).__getstate__())
    strip_dec = [{"type": "Replace", "pattern": {"String": "▁"},
                  "content": " "}, {"type": "ByteFallback"},
                 {"type": "Fuse"},
                 {"type": "Strip", "content": " ", "start": 1, "stop": 0}]
    if metaspace:
        spec["normalizer"] = None
        spec["pre_tokenizer"] = {"type": "Metaspace", "replacement": "▁",
                                 "prepend_scheme": "first", "split": split}
        spec["decoder"] = ({"type": "Metaspace", "replacement": "▁",
                            "prepend_scheme": "first", "split": split}
                           if split else {"type": "Sequence",
                                          "decoders": strip_dec})
    else:
        spec["normalizer"] = {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]}
        spec["pre_tokenizer"] = None
        spec["decoder"] = {"type": "Sequence", "decoders": strip_dec}
    return Tokenizer.from_str(json.dumps(spec))


def _word_level():
    return rtok.make_test_tokenizer([f"w{i}" for i in range(50)]
                                    + ["hello", "world"])._t


SHAPES = ["llama3", "llama3_string_merges", "qwen2", "llama2_normalizer",
          "mistral_metaspace", "metaspace_split", "word_level"]


def _build(shape, d):
    if shape.startswith("llama3"):
        tok = _byte_level_bpe(tj.LLAMA3_PATTERN, LLAMA3_SPECIALS,
                              bos="<|begin_of_text|>")
        ids = [tok.token_to_id(s) for s in LLAMA3_SPECIALS]
        return _save(tok, d, [ids[1], ids[4]], ids[0],
                     merges_as_strings=shape.endswith("string_merges"))
    if shape == "qwen2":
        tok = _byte_level_bpe(QWEN_PATTERN, QWEN_SPECIALS,
                              normalizer=normalizers.NFC())
        return _save(tok, d, tok.token_to_id("<|im_end|>"))
    if shape == "word_level":
        return _save(_word_level(), d, 2, 1)
    tok = _sentencepiece_bpe(metaspace=shape != "llama2_normalizer",
                             split=shape == "metaspace_split")
    return _save(tok, d, 2, 1)


@pytest.fixture(scope="module", params=SHAPES)
def pair(request, tmp_path_factory):
    d = _build(request.param, tmp_path_factory.mktemp(request.param))
    return ptok.HfTokenizer.from_dir(d), rtok.HfTokenizer.from_dir(d)


def _pieces(tok, ids, prompt):
    s = ptok.DecodeStream(tok, prompt)
    return [s.step(i) for i in ids]


def _check(p, r, text):
    for special in (True, False):
        ids = r.encode(text, add_special_tokens=special)
        assert p.encode(text, add_special_tokens=special) == ids, \
            (text, special)
        for skip in (True, False):
            assert p.decode(ids, skip) == r.decode(ids, skip), (text, skip)
    ids = r.encode(text)
    assert _pieces(p, ids, ids[:2]) == _pieces(r, ids, ids[:2])


def test_fixed_texts_match_the_reference(pair):
    p, r = pair
    assert (p.eos_token_ids, p.bos_token_id, p.vocab_size) == \
        (r.eos_token_ids, r.bos_token_id, r.vocab_size)
    for text in TEXTS + CORPUS[:10]:
        _check(p, r, text)
    # every id, unknown ones and specials included, decodes the same
    ids = list(range(r.vocab_size + 3))
    for skip in (True, False):
        assert p.decode(ids, skip) == r.decode(ids, skip)


_POOLS = [
    st.sampled_from(list("東京日本語中文我喜欢한국어テキスト")),
    st.sampled_from(["😀", "🚀", "🎉", "🇫🇷", "👩‍💻", "‍", "️"]),
    st.sampled_from(["é", "ä", "̃", "̧c", "é"]),
    st.text(alphabet="0123456789", min_size=1, max_size=9),
    st.text(alphabet=" \t\n\r\x0b\x0c\x1c\x1f\x85\xa0 　​"
            "﻿", min_size=1, max_size=5),
    st.sampled_from(["'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'S",
                     "'LL", "'D", "'x", "n't"]),
    st.sampled_from(LLAMA3_SPECIALS + QWEN_SPECIALS
                    + ["<s>", "</s>", "<unk>"]),
    st.text(alphabet="abcdefghijklmnopqrstuvwxyzABCXYZ", min_size=1,
            max_size=8),
    st.sampled_from(list("!?.,;:-_()[]{}<>/\\|\"'`~@#$%^&*+=¿¡—…")),
    st.characters(exclude_categories=("Cs", "Cn", "Co")),
]
_TEXT = st.lists(st.one_of(*_POOLS), max_size=14).map("".join)


@settings(max_examples=60, deadline=None)
@given(text=_TEXT)
def test_unicode_search_matches_the_reference(pair, text):
    _check(*pair, text)


@pytest.mark.parametrize("field,value,what", [
    ("normalizer", {"type": "Lowercase"}, "normalizer 'Lowercase'"),
    ("pre_tokenizer", {"type": "Digits", "individual_digits": True},
     "pre-tokenizer 'Digits'"),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\w+"},
                       "behavior": "Isolated", "invert": False},
     "escape \\w"),
    ("decoder", {"type": "WordPiece", "prefix": "##", "cleanup": True},
     "decoder 'WordPiece'"),
    ("post_processor", {"type": "BertProcessing", "sep": ["</s>", 2],
                        "cls": ["<s>", 1]}, "post-processor 'BertProcessing'"),
    ("model", {"type": "Unigram", "vocab": [["a", 0.0]], "unk_id": 0},
     "model 'Unigram'"),
    ("truncation", {"max_length": 8}, "truncation"),
])
def test_unsupported_components_raise_naming_them(tmp_path, field, value,
                                                  what):
    d = _build("llama3", tmp_path / "m")
    spec = json.loads((tmp_path / "m" / "tokenizer.json").read_text())
    spec[field] = value
    (tmp_path / "m" / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match="tokenizer.json") as e:
        ptok.HfTokenizer.from_dir(d)
    assert what in str(e.value)


def test_eos_from_tokenizer_config_when_config_has_none(tmp_path):
    d = _build("qwen2", tmp_path / "m")
    (tmp_path / "m" / "config.json").write_text("{}")
    (tmp_path / "m" / "tokenizer_config.json").write_text(json.dumps(
        {"eos_token": {"content": "<|endoftext|>"}}))
    p, r = ptok.HfTokenizer.from_dir(d), rtok.HfTokenizer.from_dir(d)
    assert p.eos_token_ids == r.eos_token_ids == [
        r._tok.token_to_id("<|endoftext|>")]
    assert p.bos_token_id is r.bos_token_id is None


def test_added_token_flags_match_the_reference(tmp_path):
    """lstrip, rstrip, single_word and normalized added tokens."""
    tok = _byte_level_bpe(tj.LLAMA3_PATTERN, LLAMA3_SPECIALS,
                          normalizer=normalizers.NFC())
    tok.add_tokens([
        AddedToken("<mask>", lstrip=True, rstrip=True, normalized=False),
        AddedToken("cat", single_word=True, normalized=True),
        AddedToken("café", normalized=True)])
    d = _save(tok, tmp_path / "m", 1)
    p, r = ptok.HfTokenizer.from_dir(d), rtok.HfTokenizer.from_dir(d)
    for text in ["a  <mask>  b", "<mask>x", "cat catalog the cat.",
                 "concat cat_ cat", "café café", "  <mask>"]:
        _check(p, r, text)


def test_pretokenizers_shared_with_gguf_match_the_library():
    """The GGUF path's pre-tokenizers are the library's regexes."""
    for pattern, fn in ((tj.GPT2_PATTERN, tj.gpt2_pretokenize),
                        (tj.LLAMA3_PATTERN, tj.llama3_pretokenize)):
        split = pre_tokenizers.Split(Regex(pattern), behavior="isolated")
        for text in TEXTS + CORPUS[:10]:
            assert fn(text) == [s for s, _ in split.pre_tokenize_str(text)]
