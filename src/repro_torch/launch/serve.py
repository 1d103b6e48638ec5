"""Serving launcher of the decoder LM: batched prefill, then greedy decode.

The torch counterpart of ``repro.launch.serve``, for every family the
reference serves (dense, moe, hybrid, ssm, vlm and the encoder-decoder).
It makes random weights from ``--seed`` (smoke-scale unless ``--full``),
prefills a batch of random prompts by teacher-forcing them through the
cached one-token step, then decodes greedily token by token against the
KV / SSM caches, and reports each phase's seconds and the decode rate.
Whisper's encoder runs once on 64 stub frames and its cross K/V are
cached; a vlm is served without images, as the reference serves it.
Every attention call goes through the ``flash_attention`` kernel on the
card.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_small \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_2b \
      --full --batch 4 --prompt-len 128 --gen 64

Runs on the GPU; ``--device cpu`` runs the plain torch path instead.
The weights and the prompt are drawn on the CPU from ``--seed`` and
moved to the device, so both devices serve the same model (the draw's
seconds are printed). :func:`main` returns the parameters, the prompt,
the tokens and the measured times as a dict.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, list_archs, smoke_variant
from repro_torch.models import encdec as ed
from repro_torch.models import frontends as fe
from repro_torch.models import transformer as tf

STUB_FRAMES = 64      # the reference's audio stub length in ``main``


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def generate(cfg, params, prompt: torch.Tensor, gen_len: int,
             frames=None) -> tuple[torch.Tensor, dict]:
    """Greedy decode. prompt [B, S0] -> tokens [B, S0 + gen_len].

    Prefill teacher-forces the prompt through the decode step one token
    at a time (it exercises exactly the serving cache path), so a run
    makes ``S0 + gen_len - 1`` steps. An encoder-decoder takes its
    ``frames`` [B, T, d]: the encoder and the cross K/V run once, before
    prefill, as the reference's ``init_encdec_caches`` does, and are
    timed apart with the caches' set-up (``caches_sec``).
    """
    b, s0 = prompt.shape
    dev = prompt.device
    _sync(dev)
    t0 = time.perf_counter()
    if cfg.family == "encdec":
        caches = ed.init_encdec_caches(cfg, params, frames, b, s0 + gen_len)
        step = ed.decode_step_encdec
    else:
        caches = tf.init_caches(cfg, b, s0 + gen_len, dev)
        step = tf.decode_step
    _sync(dev)
    caches_sec = time.perf_counter() - t0    # lint: allow(timer-no-barrier)

    t0 = time.perf_counter()
    out = None
    for i in range(s0):
        out = step(cfg, params, prompt[:, i:i + 1], caches, i)
        caches = out.caches
    _sync(dev)
    prefill_sec = time.perf_counter() - t0   # lint: allow(timer-no-barrier)

    t0 = time.perf_counter()
    cur = out.logits[:, -1].argmax(-1)[:, None]
    generated = [cur]
    for i in range(s0, s0 + gen_len - 1):
        out = step(cfg, params, cur, caches, i)
        caches = out.caches
        cur = out.logits[:, -1].argmax(-1)[:, None]
        generated.append(cur)
    _sync(dev)
    decode_sec = time.perf_counter() - t0    # lint: allow(timer-no-barrier)

    tokens = torch.cat([prompt, *generated], dim=1)
    stats = {
        "caches_sec": caches_sec,
        "prefill_sec": prefill_sec,
        "decode_sec": decode_sec,
        "decode_tok_per_sec": b * len(generated) / max(decode_sec, 1e-9),
    }
    return tokens, stats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma2_2b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths kept;"
                         " an encoder-decoder's encoder too)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain torch path)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = smoke_variant(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
        if cfg.family == "encdec":
            cfg = dataclasses.replace(cfg, n_encoder_layers=args.layers)
    print(f"arch={cfg.name} family={cfg.family} layers={cfg.n_layers} "
          f"params~{cfg.n_params():,} device={dev}")
    # weights and prompt from a CPU generator, moved to the device: the
    # same model and prompt for a seed on every device
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(args.seed)
    frames = None
    if cfg.family == "encdec":
        params = ed.init_encdec(cfg, gen, device=dev)
        frames = fe.audio_frames_stub(cfg, gen, args.batch, STUB_FRAMES,
                                      device=dev)
    else:
        params = tf.init_decoder_lm(cfg, gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen).to(dev)
    _sync(dev)
    init_sec = time.perf_counter() - t0   # lint: allow(timer-no-barrier)
    print(f"weights and prompt drawn on the CPU, placed on {dev} in "
          f"{init_sec:.2f}s")
    tokens, stats = generate(cfg, params, prompt, args.gen, frames=frames)
    print(f"generated {tuple(tokens.shape)} | prefill "
          f"{stats['prefill_sec']:.2f}s | decode {stats['decode_sec']:.2f}s "
          f"({stats['decode_tok_per_sec']:.1f} tok/s)")
    print("sample:", tokens[0, args.prompt_len:args.prompt_len + 12].tolist())
    return {"config": cfg, "params": params, "prompt": prompt,
            "frames": frames, "tokens": tokens, "init_sec": init_sec,
            **stats}


if __name__ == "__main__":
    main()
