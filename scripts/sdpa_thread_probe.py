#!/usr/bin/env python3
"""PyTorch's `scaled_dot_product_attention` from the main thread and from a
new thread, on one CUDA card, by backend: which backend the dispatcher
picks, and whether each backend gives the same bits in both threads.

    python3 scripts/sdpa_thread_probe.py

Shapes: SD-1.5's cross-attentions at 512 px with CFG (q 2 x 8 heads x
4096 / 1024 / 256 tokens, d 40 / 80 / 160, k and v 77 tokens) and its text
tower's causal self-attention (1 x 12 heads x 77 tokens, d 64), bf16. Prints
one JSON line a shape and writes `chiprun_out/sdpa_thread_probe.json`.
"""

import json
import os
import threading

SHAPES = [((2, 8, 4096, 40), 77, False), ((2, 8, 1024, 80), 77, False), ((2, 8, 256, 160), 77, False),
          ((1, 12, 77, 64), 77, True)]


def main() -> int:
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    backends = {"default": None, "flash": SDPBackend.FLASH_ATTENTION, "efficient": SDPBackend.EFFICIENT_ATTENTION,
                "cudnn": SDPBackend.CUDNN_ATTENTION, "math": SDPBackend.MATH}
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (b, h, lq, d), lk, causal in SHAPES:
        q = torch.randn((b, h, lq, d), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, h, lk, d), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
        row = {"q": [b, h, lq, d], "kv": lk, "causal": causal,
               "chosen": str(torch._fused_sdp_choice(q, k, v, is_causal=causal))}
        for name, backend in backends.items():
            def run(backend=backend):
                if backend is None:
                    return F.scaled_dot_product_attention(q, k, v, is_causal=causal)
                with sdpa_kernel([backend]):
                    return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

            try:
                main = run()
                again = run()
                out = {}
                worker = threading.Thread(target=lambda: out.update(y=run()))
                worker.start()
                worker.join()
                torch.cuda.synchronize()
                row[name] = {"main_repeats": bool(torch.equal(main, again)),
                             "thread_equal": bool(torch.equal(main, out["y"])),
                             "max_abs_diff": (main.float() - out["y"].float()).abs().max().item()}
            except Exception as e:  # noqa: BLE001 (a backend that does not take the shape)
                row[name] = f"{type(e).__name__}: {str(e)[:120]}"
        rows.append(row)
        print(json.dumps(row), flush=True)
    card = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "sdpa_thread_probe.json"), "w") as f:
        json.dump({"torch": torch.__version__, "card": card, "rows": rows}, f, indent=1)
    print(torch.__version__, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
