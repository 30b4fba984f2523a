"""Training launcher of the port: pretrain a ported architecture on one
device on the in-repo synthetic corpus (or ``--data-dir``), the
counterpart of ``repro.launch.train``.  The reference's ``--plan``,
``--mesh``, ``--devices``, ``--stages`` and ``--microbatches`` wait for
execution plans on torch.distributed (ROADMAP queue 1, item 7).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2m \\
        --steps 100 --seq 1024 --batch 8 --vocab 50257

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2m \\
        --reduced --device cpu --steps 3 --seq 32 --batch 4
"""
import argparse
import dataclasses

from repro_torch.configs import ARCH_CONFIGS


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gpt2m", choices=sorted(ARCH_CONFIGS))
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke) variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--docs", type=int, default=500,
                    help="synthetic corpus size (use --data-dir for real)")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (kernels) or cpu (plain PyTorch versions)")
    args = ap.parse_args(argv)

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import (Loader, Tokenizer, build_dataset,
                                  load_text_dir, synthetic_wikipedia)
    from repro_torch.models import Model
    from repro_torch.train import model_flops_per_step, train

    texts = list(load_text_dir(args.data_dir)) if args.data_dir else \
        list(synthetic_wikipedia(args.docs, seed=args.seed))
    tok = Tokenizer.train(texts, args.vocab)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, vocab_size=tok.vocab_size,
                              max_seq_len=max(cfg.max_seq_len, args.seq))
    ds = build_dataset(texts, tok, seq_len=args.seq)
    loader = Loader(ds, global_batch=args.batch, seed=args.seed)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=args.steps // 10,
                       total_steps=args.steps, seed=args.seed)
    model = Model(cfg, device=args.device)
    print(f"{cfg.name} [{cfg.family}] {cfg.param_count() / 1e6:.1f}M params "
          f"| one device: {model.device}")
    res = train(model, tcfg, loader, steps=args.steps,
                log_every=max(args.steps // 10, 1), ckpt_dir=args.ckpt_dir)
    flops = model_flops_per_step(cfg, args.batch * args.seq)
    print(f"done: loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}; "
          f"{res.tflops(flops):.4f} TFLOP/s avg")
    return res


if __name__ == "__main__":
    main()
