"""Client-side token drafting for speculative decoding.

The reference pays one WAN round trip per generated token — its dominant
latency term (SURVEY.md §3.2 hot loop 2). Speculative decoding amortizes it:
the client drafts K candidate tokens, ships them through the pipeline as ONE
multi-token step, and the final stage greedily verifies them against the real
model (executor.forward draft path), returning up to K+1 tokens per round
trip.

The default drafter is **prompt-lookup (n-gram) drafting**: propose the K
tokens that followed the most recent earlier occurrence of the current
suffix n-gram. It needs no extra weights — crucial here, because the client
only holds stage0 of the model — and does well exactly where autoregressive
decoding is most wasteful (repetitive spans, quoted context, code). When no
n-gram matches, the round degrades to a normal single-token step.

Pluggable: `PipelineClient.generate(draft_fn=...)` accepts anything with
this signature, e.g. a small full draft model run client-side.
"""

from __future__ import annotations

from typing import Sequence, Tuple


def ngram_draft(context: Sequence[int], k: int, *,
                max_ngram: int = 3, min_ngram: int = 1) -> Tuple[int, ...]:
    """Draft up to ``k`` tokens by prompt lookup.

    Finds the longest suffix n-gram (``max_ngram`` down to ``min_ngram``)
    with an earlier occurrence in ``context`` and returns the tokens that
    followed its MOST RECENT occurrence. Returns () when nothing matches
    (caller falls back to a plain decode step).
    """
    if k <= 0 or len(context) < min_ngram + 1:
        return ()
    ctx = list(context)
    n_ctx = len(ctx)
    for n in range(min(max_ngram, n_ctx - 1), min_ngram - 1, -1):
        suffix = ctx[-n:]
        # Scan right-to-left for the most recent earlier occurrence: recent
        # matches predict the continuation better than distant ones.
        for start in range(n_ctx - n - 1, -1, -1):
            if ctx[start:start + n] == suffix:
                follow = ctx[start + n:start + n + k]
                if follow:
                    return tuple(int(t) for t in follow)
    return ()
