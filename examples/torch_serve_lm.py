"""Serving example on the PyTorch/CUDA port: batched autoregressive decoding
with prefill + KV cache, with *space-sharing* across concurrent request
batches via the scheduler (independent batches land on separate lanes,
CUDA streams on the card: the paper's multi-task overlap applied to
inference).

    PYTHONPATH=src python examples/torch_serve_lm.py --requests 4 --new-tokens 16
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

Weights are random, drawn from a generator seeded 0 on ``--device``.  On
the card the RMSNorm kernel runs in every norm of gemma3 (the default
``--arch``); ``--arch rwkv6_1_6b`` also runs the WKV6 kernel in prefill and
decode.  Without a CUDA device and without ``--device cpu`` it raises.
"""
import argparse
import time
from typing import List

import numpy as np
import torch

import repro_torch.api as gr
from repro_torch.configs import get_config
from repro_torch.core.managed import ManagedValue
from repro_torch.models import init_cache, init_lm
from repro_torch.runtime import make_decode_step, make_prefill_step


def serve_requests(sched, cfg, model, prompts: List[np.ndarray],
                   new_tokens: int) -> List[np.ndarray]:
    """Serves each (batch, prompt_len) int32 prompt array as one request
    batch on ``sched``: a prefill, then greedy decoding of ``new_tokens``
    tokens.  Returns each batch's (batch, new_tokens) int32 tokens."""
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)
    weights = ManagedValue(sched, model, name="weights")

    @torch.no_grad()        # grad mode is per thread: this runs on a lane's
    def kernel(p, toks, _out):
        """One request batch: prefill then greedy decode (device kernel)."""
        max_len = toks.shape[1] + new_tokens
        cache = init_cache(cfg, toks.shape[0], max_len, device=toks.device)
        logits, cache = prefill(p, {"tokens": toks}, cache)
        nxt = torch.argmax(logits, -1)[:, None].to(torch.int32)
        outs = [nxt]
        pos = toks.shape[1]
        for i in range(new_tokens - 1):
            nxt, _, cache = decode(p, nxt, cache, pos + i)
            outs.append(nxt)
        return torch.cat(outs, dim=1)

    # Declared once: const weights, const prompts, out generated tokens.
    serve = gr.function(kernel, modes=("const", "const", "out"),
                        name="serve", scheduler=sched)

    results = []
    for r, prompt in enumerate(prompts):
        toks = sched.array(prompt, name=f"req{r}")
        out_toks = sched.array(
            np.zeros((prompt.shape[0], new_tokens), np.int32), name=f"gen{r}")
        # independent requests share read-only weights: separate lanes
        serve.with_options(name=f"serve_req{r}")(weights, toks, out_toks)
        results.append(out_toks)
    return [np.asarray(r) for r in results]     # host reads sync per lane


def main(argv=None) -> List[np.ndarray]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3_12b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="where the weights and lanes live: cuda or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=True)
    sched = gr.make_scheduler("parallel", device=args.device)
    try:
        model = init_lm(cfg, torch.Generator(args.device).manual_seed(0),
                        args.device)
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, cfg.vocab, (args.batch, args.prompt_len))
                   .astype(np.int32) for _ in range(args.requests)]

        t0 = time.time()
        texts = serve_requests(sched, cfg, model, prompts, args.new_tokens)
        dt = time.time() - t0
        total = args.requests * args.batch * args.new_tokens
        print(f"served {args.requests} request batches "
              f"({total} tokens) in {dt:.2f}s -> {total/dt:.1f} tok/s")
        print("lanes used:", sched.streams.lanes_created,
              "| events:", sched.streams.events_created)
        for r, t in enumerate(texts[:2]):
            print(f"req{r} sample tokens:", t[0][:8], "...")
    finally:
        sched.shutdown()
    return texts


if __name__ == "__main__":
    main()
