"""Backend (post-processing) stage: detokenize + stop conditions.

Wraps an engine's token stream: incremental detokenization, stop-token
enforcement, max_tokens, and the stop-string *jail* — text that partially
matches a stop sequence is held back until it either completes the stop
sequence (dropped, stream finished) or diverges (released). Mirrors the
reference Backend (lib/llm/src/backend.rs:67; jail logic backend.rs:295-301).
A copy of the JAX package's backend.py; here ``transform`` also closes the
engine stream when it ends or is closed, so a client that goes away frees
its engine slot at once rather than when the stream is collected.
"""
from __future__ import annotations

from typing import AsyncIterator

from dynamo_tpu_torch.protocols.common import FinishReason, LLMEngineOutput, StopConditions
from dynamo_tpu_torch.tokenizer import DecodeStream, Tokenizer


class StopJail:
    """Stop-string matcher with partial-match holdback."""

    def __init__(self, stops: list[str]):
        self.stops = [s for s in stops if s]
        self.held = ""

    def push(self, text: str) -> tuple[str, bool]:
        """Feed text; return (releasable_text, stopped)."""
        if not self.stops:
            return text, False
        self.held += text
        # full match anywhere in held -> emit up to match, stop
        best = None
        for s in self.stops:
            i = self.held.find(s)
            if i != -1 and (best is None or i < best[0]):
                best = (i, s)
        if best is not None:
            out = self.held[: best[0]]
            self.held = ""
            return out, True
        # longest suffix of held that could start a stop string stays jailed
        jail_len = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(self.held)), 0, -1):
                if self.held.endswith(s[:k]):
                    jail_len = max(jail_len, k)
                    break
        if jail_len:
            out, self.held = self.held[:-jail_len], self.held[-jail_len:]
        else:
            out, self.held = self.held, ""
        return out, False

    def flush(self) -> str:
        out, self.held = self.held, ""
        return out


class Backend:
    """Detokenizing post-processor; one instance per model."""

    def __init__(self, tokenizer: Tokenizer):
        self.tokenizer = tokenizer

    async def transform(
        self,
        stream: AsyncIterator[LLMEngineOutput],
        *,
        prompt_ids: list[int],
        stop: StopConditions,
    ) -> AsyncIterator[LLMEngineOutput]:
        """Engine token stream -> text-delta stream with stop enforcement."""
        decoder = DecodeStream(self.tokenizer, prompt_ids)
        jail = StopJail(stop.stop or [])
        stop_ids = set(stop.stop_token_ids or [])
        if stop.ignore_eos:
            stop_ids = set()
        produced = 0
        finished = False
        # carried across engine outputs: entries for tokens whose text was
        # held back (jail/partial UTF-8) must not be dropped — one entry
        # per emitted token is the OpenAI contract
        pending_entries: list[dict] = []

        def tok_entry(tid: int, logprob: float, tops) -> dict:
            """OpenAI logprobs content entry: token string + bytes + top
            alternatives (delta.rs logprobs plumbing)."""
            s = self.tokenizer.decode([tid], skip_special_tokens=False)
            entry: dict = {
                "token": s, "logprob": logprob, "bytes": list(s.encode()),
            }
            if tops is not None:
                entry["top_logprobs"] = [
                    {
                        "token": (
                            ts := self.tokenizer.decode(
                                [int(i)], skip_special_tokens=False
                            )
                        ),
                        "logprob": float(v),
                        "bytes": list(ts.encode()),
                    }
                    for i, v in tops
                ]
            return entry

        try:
            async for out in stream:
                text_parts: list[str] = []
                finish: FinishReason | None = out.finish_reason
                emitted_ids: list[int] = []
                for idx, tid in enumerate(out.token_ids):
                    produced += 1
                    hit_stop_id = tid in stop_ids and (
                        stop.min_tokens is None or produced >= stop.min_tokens
                    )
                    if not hit_stop_id:
                        emitted_ids.append(tid)
                        if out.log_probs is not None and idx < len(out.log_probs):
                            tops = (out.top_logprobs[idx]
                                    if out.top_logprobs else None)
                            pending_entries.append(
                                tok_entry(tid, out.log_probs[idx], tops)
                            )
                        piece = decoder.step(tid)
                        if piece:
                            released, stopped = jail.push(piece)
                            if released:
                                text_parts.append(released)
                            if stopped:
                                finish = FinishReason.STOP
                                break
                    else:
                        finish = FinishReason.EOS
                        break
                    if stop.max_tokens is not None and produced >= stop.max_tokens:
                        finish = finish or FinishReason.LENGTH
                        break
                if finish is not None and finish not in (FinishReason.STOP,):
                    # natural end: release any jailed partial match
                    tail = jail.flush()
                    if tail:
                        text_parts.append(tail)
                if text_parts or finish is not None or out.annotations:
                    lp_entries, pending_entries = pending_entries, []
                    yield LLMEngineOutput(
                        token_ids=emitted_ids,
                        text="".join(text_parts) or None,
                        finish_reason=finish,
                        cum_log_probs=out.cum_log_probs,
                        log_probs=(
                            out.log_probs[: len(emitted_ids)]
                            if out.log_probs is not None else None
                        ),
                        top_logprobs=(
                            out.top_logprobs[: len(emitted_ids)]
                            if out.top_logprobs is not None else None
                        ),
                        logprob_entries=lp_entries or None,
                        annotations=out.annotations,
                    )
                if finish is not None:
                    finished = True
                    break
        finally:
            close = getattr(stream, "aclose", None)
            if close is not None:
                await close()
        if not finished:
            # engine stream ended without a finish reason: surface as error-free EOS
            tail = jail.flush()
            yield LLMEngineOutput(
                token_ids=[], text=tail or None, finish_reason=FinishReason.EOS
            )
