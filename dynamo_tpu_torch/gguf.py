"""GGUF metadata, tokenizer and weight reader (a copy of the JAX
package's gguf.py; reference lib/llm/src/gguf/: content.rs metadata
extraction + gguf_tokenizer.rs:587 tokenizer conversion). A pure-python
reader of the public GGUF v2/v3 container: header, typed metadata KV
table, tensor descriptors, and the tensor data of the classic formats.

Provides:
  - ``read_gguf(path)`` -> (metadata dict, tensor descriptors)
  - ``config_from_gguf(metadata)`` -> ModelConfig (llama-family keys)
  - ``GgufTokenizer`` — a SentencePiece-unigram encoder/decoder built
    from ``tokenizer.ggml.tokens``/``scores`` (Viterbi segmentation +
    byte fallback); ``GgufBpeTokenizer`` — the byte-level BPE of
    "gpt2"-model vocabs (the llama-3 family), whose pre-tokenizers are
    tokenizer_json.py's (one copy for the GGUF and the HF paths);
    ``gguf_tokenizer(metadata)`` picks one
  - ``dequantize_tensor`` (F32/F16/Q4_0/Q4_1/Q5_0/Q5_1/Q8_0, in torch on
    the host) and ``load_gguf_params``, which fills the port's parameter
    tree through models/llama.py ``params_from_state_dict``.
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO, Iterator, Mapping, Optional

from dynamo_tpu_torch.tokenizer_json import (
    BYTE_DEC as _BYTE_DEC,
    BYTE_ENC as _BYTE_ENC,
    gpt2_pretokenize,
    llama3_pretokenize,
)

GGUF_MAGIC = b"GGUF"

# metadata value types (spec)
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL = range(8)
_T_STRING, _T_ARRAY, _T_U64, _T_I64, _T_F64 = 8, 9, 10, 11, 12

_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_U64: "<Q",
    _T_I64: "<q", _T_F64: "<d",
}


def _read_fmt(f: BinaryIO, fmt: str):
    size = struct.calcsize(fmt)
    data = f.read(size)
    if len(data) != size:
        raise ValueError("truncated GGUF file")
    return struct.unpack(fmt, data)[0]


def _read_string(f: BinaryIO) -> str:
    n = _read_fmt(f, "<Q")
    if n > 1 << 30:
        raise ValueError("implausible GGUF string length")
    return f.read(n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype in _SCALAR_FMT:
        return _read_fmt(f, _SCALAR_FMT[vtype])
    if vtype == _T_BOOL:
        return bool(_read_fmt(f, "<B"))
    if vtype == _T_STRING:
        return _read_string(f)
    if vtype == _T_ARRAY:
        etype = _read_fmt(f, "<I")
        count = _read_fmt(f, "<Q")
        if count > 1 << 28:
            raise ValueError("implausible GGUF array length")
        return [_read_value(f, etype) for _ in range(count)]
    raise ValueError(f"unknown GGUF value type {vtype}")


def read_gguf(path: str) -> tuple[dict[str, Any], list[dict[str, Any]]]:
    """Parse header + metadata + tensor descriptors (no tensor data)."""
    with open(path, "rb") as f:
        if f.read(4) != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        version = _read_fmt(f, "<I")
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors = _read_fmt(f, "<Q")
        n_kv = _read_fmt(f, "<Q")
        metadata: dict[str, Any] = {"gguf.version": version}
        for _ in range(n_kv):
            key = _read_string(f)
            vtype = _read_fmt(f, "<I")
            metadata[key] = _read_value(f, vtype)
        tensors = []
        for _ in range(n_tensors):
            name = _read_string(f)
            n_dims = _read_fmt(f, "<I")
            dims = [_read_fmt(f, "<Q") for _ in range(n_dims)]
            dtype = _read_fmt(f, "<I")
            offset = _read_fmt(f, "<Q")
            tensors.append({
                "name": name, "dims": dims, "dtype": dtype,
                "offset": offset,
            })
        # tensor DATA begins here, aligned — recorded so loaders don't
        # re-walk the header (tensor offsets are relative to this)
        align = int(metadata.get("general.alignment", 32) or 32)
        metadata["gguf.data_offset"] = (f.tell() + align - 1) // align * align
        return metadata, tensors


def config_from_gguf(md: dict[str, Any]) -> "Any":
    """ModelConfig from llama-family GGUF metadata keys."""
    from dynamo_tpu_torch.models.config import ModelConfig

    arch = md.get("general.architecture", "llama")
    if arch not in ("llama", "llama2", "llama3"):
        raise ValueError(f"unsupported GGUF architecture {arch!r}")

    def k(name, default=None):
        return md.get(f"{arch}.{name}", default)

    heads = int(k("attention.head_count"))
    emb = int(k("embedding_length"))
    n_vocab = md.get(f"{arch}.vocab_size")
    if n_vocab is None:
        n_vocab = len(md.get("tokenizer.ggml.tokens", []) or [])
    return ModelConfig(
        vocab_size=int(n_vocab),
        hidden_size=emb,
        intermediate_size=int(k("feed_forward_length")),
        num_layers=int(k("block_count")),
        num_heads=heads,
        num_kv_heads=int(k("attention.head_count_kv", heads)),
        head_dim=int(k("attention.key_length", emb // heads)),
        rope_theta=float(k("rope.freq_base", 10000.0)),
        rms_norm_eps=float(k("attention.layer_norm_rms_epsilon", 1e-5)),
        max_position_embeddings=int(k("context_length", 8192)),
    )


class GgufTokenizer:
    """SentencePiece-unigram tokenizer from GGUF vocab tables.

    Encode = Viterbi segmentation maximizing summed piece scores (the SPM
    algorithm), with byte-fallback pieces (<0xNN>) for uncovered bytes.
    Decode maps pieces back, translating the U+2581 space marker."""

    SPACE = "▁"

    def __init__(self, tokens: list[str], scores: list[float],
                 bos_id: Optional[int] = None, eos_id: Optional[int] = None,
                 add_bos: bool = True, unk_id: int = 0):
        self.tokens = tokens
        self.scores = scores
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.add_bos = add_bos and bos_id is not None
        self.unk_id = unk_id
        self.piece_to_id = {t: i for i, t in enumerate(tokens)}
        self.max_piece_len = max((len(t) for t in tokens), default=1)
        self._byte_ids = {}
        for i, t in enumerate(tokens):
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                self._byte_ids[int(t[3:5], 16)] = i

    @classmethod
    def from_metadata(cls, md: dict[str, Any]) -> "GgufTokenizer":
        model = md.get("tokenizer.ggml.model", "llama")
        if model not in ("llama", "spm"):
            raise ValueError(
                f"GGUF tokenizer model {model!r} is not supported "
                "(SentencePiece-unigram only; BPE GGUFs need their "
                "original HF tokenizer)"
            )
        tokens = md.get("tokenizer.ggml.tokens")
        scores = md.get("tokenizer.ggml.scores")
        if not tokens:
            raise ValueError("GGUF file carries no tokenizer vocab")
        if not scores:
            scores = [0.0] * len(tokens)
        return cls(
            list(tokens), [float(s) for s in scores],
            bos_id=md.get("tokenizer.ggml.bos_token_id"),
            eos_id=md.get("tokenizer.ggml.eos_token_id"),
            add_bos=bool(md.get("tokenizer.ggml.add_bos_token", True)),
            unk_id=int(md.get("tokenizer.ggml.unknown_token_id", 0) or 0),
        )

    # ---- encode (Viterbi over piece scores) ----

    def _segment(self, text: str) -> list[int]:
        n = len(text)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: list[Optional[tuple[int, int]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] <= NEG / 2:
                continue
            hi = min(n, i + self.max_piece_len)
            for j in range(i + 1, hi + 1):
                pid = self.piece_to_id.get(text[i:j])
                if pid is None:
                    continue
                s = best[i] + self.scores[pid]
                if s > best[j]:
                    best[j] = s
                    back[j] = (i, pid)
            # byte fallback keeps segmentation total (scored far below
            # any real piece, as SPM does)
            bts = text[i].encode("utf-8")
            if all(b in self._byte_ids for b in bts):
                s = best[i] - 1e6 * len(bts)
                if s > best[i + 1]:
                    best[i + 1] = s
                    back[i + 1] = (i, -1)
        if back[n] is None:
            return [self.unk_id]
        out: list[int] = []
        pos = n
        while pos > 0:
            i, pid = back[pos]
            if pid == -1:
                out.extend(reversed([
                    self._byte_ids[b] for b in text[i:pos].encode("utf-8")
                ]))
            else:
                out.append(pid)
            pos = i
        out.reverse()
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        norm = self.SPACE + text.replace(" ", self.SPACE)
        ids = self._segment(norm)
        if self.add_bos and add_special_tokens:
            return [self.bos_id] + ids
        return ids

    # ---- decode ----

    def decode(self, ids: list[int], skip_special_tokens: bool = True) -> str:
        parts: list[str] = []
        pending: list[int] = []

        def flush_bytes():
            if pending:
                parts.append(bytes(pending).decode("utf-8",
                                                   errors="replace"))
                pending.clear()

        for i in ids:
            if i in (self.bos_id, self.eos_id):
                continue
            t = self.tokens[i] if 0 <= i < len(self.tokens) else ""
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                pending.append(int(t[3:5], 16))
                continue
            flush_bytes()
            parts.append(t.replace(self.SPACE, " "))
        flush_bytes()
        text = "".join(parts)
        return text[1:] if text.startswith(" ") else text

    @property
    def stop_token_ids(self) -> list[int]:
        return [self.eos_id] if self.eos_id is not None else []

    @property
    def eos_token_ids(self) -> list[int]:
        return self.stop_token_ids

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)


# ---------------------------------------------------------------------------
# BPE ("gpt2"-model) GGUF tokenizer — the llama-3-family vocab form
# (reference gguf_tokenizer.rs:111,222 converts these to HF tokenizers;
# here the byte-level BPE is implemented directly).

class GgufBpeTokenizer:
    """Byte-level BPE tokenizer from GGUF "gpt2"-model vocab tables
    (``tokenizer.ggml.tokens`` + ``tokenizer.ggml.merges``) — the llama-3
    GGUF family. Control tokens (token_type 3) are matched verbatim
    before pretokenization so chat-template markup round-trips."""

    def __init__(self, tokens: list[str], merges: list[str],
                 token_types: Optional[list[int]] = None,
                 bos_id: Optional[int] = None, eos_id: Optional[int] = None,
                 add_bos: bool = True, pre: str = "gpt2"):
        self.tokens = tokens
        self.piece_to_id = {t: i for i, t in enumerate(tokens)}
        self.ranks: dict[tuple[str, str], int] = {}
        for r, m in enumerate(merges):
            a, _, b = m.partition(" ")
            self.ranks[(a, b)] = r
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.add_bos = add_bos and bos_id is not None
        self.pre = pre
        self.specials: dict[str, int] = {}
        if token_types:
            for i, t in enumerate(token_types):
                if t == 3:  # control
                    self.specials[tokens[i]] = i
        # one compiled alternation, longest-first so overlapping control
        # names resolve to the longest match in a single pass (llama-3
        # carries ~256 control tokens; per-special rescans of the text
        # would be quadratic on the serving hot path)
        self._special_re = None
        if self.specials:
            import re

            self._special_re = re.compile("|".join(
                re.escape(s)
                for s in sorted(self.specials, key=len, reverse=True)
            ))
        self._pretok = (llama3_pretokenize
                        if pre in ("llama-bpe", "llama3")
                        else gpt2_pretokenize)

    @classmethod
    def from_metadata(cls, md: dict[str, Any]) -> "GgufBpeTokenizer":
        return cls(
            list(md["tokenizer.ggml.tokens"]),
            list(md.get("tokenizer.ggml.merges") or []),
            md.get("tokenizer.ggml.token_type"),
            bos_id=md.get("tokenizer.ggml.bos_token_id"),
            eos_id=md.get("tokenizer.ggml.eos_token_id"),
            add_bos=bool(md.get("tokenizer.ggml.add_bos_token", True)),
            pre=md.get("tokenizer.ggml.pre", "gpt2"),
        )

    def _bpe(self, word: str) -> list[str]:
        parts = list(word)
        while len(parts) > 1:
            best = None
            best_rank = None
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            parts[best : best + 2] = [parts[best] + parts[best + 1]]
        return parts

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids: list[int] = []
        if add_special_tokens and self.add_bos:
            ids.append(self.bos_id)
        # split on control tokens first (longest match wins)
        segments: list[tuple[bool, str]] = []
        if self._special_re is not None:
            pos = 0
            for m in self._special_re.finditer(text):
                if m.start() > pos:
                    segments.append((False, text[pos:m.start()]))
                segments.append((True, m.group()))
                pos = m.end()
            if pos < len(text):
                segments.append((False, text[pos:]))
        else:
            segments = [(False, text)]
        for is_special, seg in segments:
            if is_special:
                ids.append(self.specials[seg])
                continue
            for piece in self._pretok(seg):
                mapped = "".join(_BYTE_ENC[b] for b in piece.encode("utf-8"))
                for sub in self._bpe(mapped):
                    pid = self.piece_to_id.get(sub)
                    if pid is None:  # fall back to single mapped bytes
                        ids.extend(
                            self.piece_to_id.get(ch, 0) for ch in sub
                        )
                    else:
                        ids.append(pid)
        return ids

    def decode(self, ids: list[int], skip_special_tokens: bool = True) -> str:
        buf = bytearray()
        for i in ids:
            if not 0 <= i < len(self.tokens):
                continue
            t = self.tokens[i]
            if t in self.specials or i in (self.bos_id, self.eos_id):
                if not skip_special_tokens:
                    buf.extend(t.encode("utf-8"))
                continue
            for ch in t:
                b = _BYTE_DEC.get(ch)
                if b is None:
                    buf.extend(ch.encode("utf-8"))
                else:
                    buf.append(b)
        return buf.decode("utf-8", errors="replace")

    @property
    def stop_token_ids(self) -> list[int]:
        ids = [self.eos_id] if self.eos_id is not None else []
        for name in ("<|eot_id|>", "<|end_of_text|>", "<|im_end|>"):
            i = self.specials.get(name)
            if i is not None and i not in ids:
                ids.append(i)
        return ids

    @property
    def eos_token_ids(self) -> list[int]:
        return self.stop_token_ids

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)


def gguf_tokenizer(md: dict[str, Any]):
    """Tokenizer from GGUF metadata: unigram (llama/spm) or byte-level
    BPE (gpt2 — the llama-3 family)."""
    model = md.get("tokenizer.ggml.model", "llama")
    if model == "gpt2":
        return GgufBpeTokenizer.from_metadata(md)
    return GgufTokenizer.from_metadata(md)


# ---------------------------------------------------------------------------
# Tensor data: dequantization + HF-layout param loading (closes the
# round-4 "weights dequant not wired" gap; reference reads GGUF tensors
# via ggml in lib/engines/llamacpp).

# ggml tensor dtypes (public spec ids)
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0 = 8

_GGML_BLOCK = {
    # dtype -> (elems per block, bytes per block)
    GGML_F32: (1, 4), GGML_F16: (1, 2),
    GGML_Q4_0: (32, 18), GGML_Q4_1: (32, 20),
    GGML_Q5_0: (32, 22), GGML_Q5_1: (32, 24),
    GGML_Q8_0: (32, 34),
}

_GGML_NAMES = {2: "Q4_0", 3: "Q4_1", 6: "Q5_0", 7: "Q5_1", 8: "Q8_0",
               10: "Q2_K", 11: "Q3_K", 12: "Q4_K", 13: "Q5_K",
               14: "Q6_K", 15: "Q8_K"}


def dequantize_tensor(dtype: int, data, n_elems: int):
    """Dequantize one tensor's raw bytes (``bytes`` or a ``bytearray``) to
    an f32 CPU tensor: the reference's numpy formulas, in torch on the
    host (its threads). Supports the classic formats
    (F32/F16/Q4_0/Q4_1/Q5_0/Q5_1/Q8_0); K-quants raise with the format
    name."""
    import torch

    if dtype not in _GGML_BLOCK:
        raise ValueError(
            f"GGUF tensor format {_GGML_NAMES.get(dtype, dtype)} is not "
            "supported (classic formats F16/F32/Q4_0/Q4_1/Q5_0/Q5_1/Q8_0 "
            "are; re-export K-quant files as Q8_0)"
        )
    elems, bsz = _GGML_BLOCK[dtype]
    nblk = n_elems // elems
    if len(data) < nblk * bsz:
        raise ValueError(f"truncated GGUF tensor data ({len(data)} bytes, "
                         f"{nblk * bsz} needed)")
    u8 = torch.frombuffer(data if isinstance(data, bytearray)
                          else bytearray(data), dtype=torch.uint8)
    if dtype == GGML_F32:
        return u8[:n_elems * 4].view(torch.float32).clone()
    if dtype == GGML_F16:
        return u8[:n_elems * 2].view(torch.float16).float()
    raw = u8[:nblk * bsz].view(nblk, bsz)

    def f16(col):  # [nblk, 1] f32 from two little-endian bytes
        return raw[:, col:col + 2].contiguous().view(torch.float16).float()

    if dtype == GGML_Q8_0:
        q = raw[:, 2:34].contiguous().view(torch.int8).float()
        return (q * f16(0)).reshape(-1)[:n_elems]
    if dtype in (GGML_Q4_0, GGML_Q4_1):
        off = 2 if dtype == GGML_Q4_0 else 4
        qs = raw[:, off:off + 16]
        # elems 0..15 in the low nibbles, 16..31 in the high ones
        x = torch.cat([qs & 0x0F, qs >> 4], dim=1).float()
        if dtype == GGML_Q4_0:
            x = (x - 8.0) * f16(0)
        else:
            x = x * f16(0) + f16(2)
        return x.reshape(-1)[:n_elems]
    if dtype in (GGML_Q5_0, GGML_Q5_1):
        off = 2 if dtype == GGML_Q5_0 else 4
        qh = raw[:, off:off + 4].contiguous().view(torch.int32).long() \
            & 0xFFFFFFFF                                     # [nblk, 1]
        qs = raw[:, off + 4:off + 20].long()
        j = torch.arange(16)
        lo = (qs & 0x0F) | (((qh >> j) & 1) << 4)
        hi = (qs >> 4) | (((qh >> (j + 16)) & 1) << 4)
        x = torch.cat([lo, hi], dim=1).float()
        if dtype == GGML_Q5_0:
            x = (x - 16.0) * f16(0)
        else:
            x = x * f16(0) + f16(2)
        return x.reshape(-1)[:n_elems]
    raise AssertionError


def _unpermute_rope(w, n_head: int):
    """Invert the HF->GGUF attn q/k row permutation (the GGUF layout
    serves llama.cpp's interleaved-rope kernels; ops/rope.py uses the HF
    rotate-half convention, so rows go back). w is [out, in]."""
    out_dim = w.shape[0]
    half = out_dim // n_head // 2
    return (w.reshape(n_head, half, 2, *w.shape[1:])
             .swapaxes(1, 2)
             .reshape(w.shape))


class _GgufTensors(Mapping[str, Any]):
    """A GGUF file's llama tensors under their HF names, each read and
    dequantized (f32 CPU tensors, HF ``[out, in]`` layout) when it is
    asked for: the host holds one tensor's bytes and values at a time."""

    _NAMES = {
        "token_embd.weight": "model.embed_tokens.weight",
        "output_norm.weight": "model.norm.weight",
        "output.weight": "lm_head.weight",
    }
    _LAYER = {
        "attn_q.weight": "self_attn.q_proj.weight",
        "attn_k.weight": "self_attn.k_proj.weight",
        "attn_v.weight": "self_attn.v_proj.weight",
        "attn_output.weight": "self_attn.o_proj.weight",
        "ffn_gate.weight": "mlp.gate_proj.weight",
        "ffn_up.weight": "mlp.up_proj.weight",
        "ffn_down.weight": "mlp.down_proj.weight",
        "attn_norm.weight": "input_layernorm.weight",
        "ffn_norm.weight": "post_attention_layernorm.weight",
    }

    def __init__(self, config, path: str):
        self.config, self.path = config, path
        md, tensors = read_gguf(path)
        self._data_start = md["gguf.data_offset"]
        self._desc: dict[str, dict[str, Any]] = {}
        for t in tensors:
            name = self._hf_name(t["name"])
            if name is not None:
                self._desc[name] = t
        if ("lm_head.weight" not in self._desc
                and "model.embed_tokens.weight" in self._desc
                and not config.tie_word_embeddings):
            self._desc["lm_head.weight"] = self._desc[
                "model.embed_tokens.weight"]

    @classmethod
    def _hf_name(cls, gname: str) -> Optional[str]:
        if gname in cls._NAMES:
            return cls._NAMES[gname]
        if gname.startswith("blk."):
            _, idx, rest = gname.split(".", 2)
            sub = cls._LAYER.get(rest)
            return None if sub is None else f"model.layers.{idx}.{sub}"
        return None

    def __getitem__(self, name: str):
        t = self._desc[name]
        n_elems = 1
        for d in t["dims"]:
            n_elems *= d
        elems, bsz = _GGML_BLOCK.get(t["dtype"], (1, 4))
        nbytes = (
            n_elems * (4 if t["dtype"] == GGML_F32 else 2)
            if t["dtype"] in (GGML_F32, GGML_F16)
            else n_elems // elems * bsz
        )
        buf = bytearray(nbytes)
        with open(self.path, "rb") as f:
            f.seek(self._data_start + t["offset"])
            f.readinto(buf)
        x = dequantize_tensor(t["dtype"], buf, n_elems)
        # GGUF dims are [ne0 (contiguous), ne1, ...] -> the shape
        # reversed; a 2-d weight lands [out, in] like HF
        x = x.reshape(tuple(reversed(t["dims"])))
        if t["name"].endswith("attn_q.weight"):
            x = _unpermute_rope(x, self.config.num_heads)
        elif t["name"].endswith("attn_k.weight"):
            x = _unpermute_rope(x, self.config.num_kv_heads)
        return x

    def __iter__(self) -> Iterator[str]:
        return iter(self._desc)

    def __len__(self) -> int:
        return len(self._desc)


def load_gguf_params(config, path: str, dtype=None, device="cuda"):
    """Read and dequantize a GGUF file's tensors on the host into
    the llama parameter tree on ``device``, through the same HF-name
    assembly the safetensors loader uses (models/llama.py
    ``params_from_state_dict``: stacking, transposes and quantization at
    load under ``config.quant="int8"`` stay in one place). A file without
    ``output.weight`` serves its embedding as the head."""
    from dynamo_tpu_torch.models import llama as _llama

    return _llama.params_from_state_dict(
        config, lambda: _GgufTensors(config, path), dtype, device)
