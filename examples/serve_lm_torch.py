"""LM serving example on the PyTorch port: batched greedy decoding with KV
caches for a dense, the hybrid, an MoE, the xLSTM or the encoder-decoder
architecture (reduced config). On the card the attention runs the port's
CUDA kernels (the split-K decode kernel reads the cache, a ring in a
windowed layer, in place in every layer of every step; grok's logit
softcap inside the kernels; the encoder-decoder's cross-attention against
the encoder memory of a zero frontend, as the reference service encodes);
``--device cpu`` runs the plain PyTorch versions.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch hymba-1.5b \\
        --device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py \\
        --arch deepseek-moe-16b --device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py \\
        --arch seamless-m4t-medium --device cpu
"""
import argparse

from repro_torch.launch.serve import ServeConfig, serve


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen2-1.5b",
                   help="a dense architecture (qwen2-1.5b, llama3.2-3b, "
                        "internlm2-1.8b, codeqwen1.5-7b, the M-RoPE "
                        "qwen2-vl-72b), the hybrid hymba-1.5b, an MoE one "
                        "(deepseek-moe-16b, grok-1-314b), the xLSTM "
                        "xlstm-350m or the encoder-decoder "
                        "seamless-m4t-medium")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    args = p.parse_args()
    out = serve(ServeConfig(arch=args.arch, batch=args.batch, prompt_len=16,
                            gen=args.gen, max_len=64), device=args.device)
    print("generated token ids (first sequence):",
          out["tokens"][0].tolist())


if __name__ == "__main__":
    main()
