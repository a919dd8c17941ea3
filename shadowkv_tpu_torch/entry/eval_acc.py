"""Accuracy evaluation entry point (counterpart of
``shadowkv_tpu/entry/eval_acc.py``, after the reference's
``test/eval_acc.py``):

    python -m shadowkv_tpu_torch.entry.eval_acc \
        --model_name meta-llama/Meta-Llama-3.1-8B-Instruct \
        --model_dir DIR --datalen 131072 --method shadow \
        --dataset_name ruler/niah_single_1,ruler/qa_2 \
        --sparse_budget 2048 --rank 160 --chunk_size 8

Data parallelism across processes is the reference's: launch with
``torchrun --nproc_per_node N``; each process evaluates a dataset shard
(``eval/evaluator.py::init_dist``). The archive path scheme is JAX's. The
kernels build once into ``kernels/build.py``'s directory; there is no
compile cache to enable.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument(
        "--model_name", type=str,
        default="gradientai/Llama-3-8B-Instruct-Gradient-1048k",
    )
    p.add_argument(
        "--dataset_name", type=lambda s: s.split(","),
        default=["ruler/niah_single_1"],
    )
    p.add_argument("--num_samples", type=int, default=-1)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--datalen", type=int, default=128 * 1024)
    p.add_argument(
        "--method", type=str, default="full",
        choices=["full", "shadow", "shadow_offload", "shadowkv",
                 "shadowkv_cpu"],
    )
    p.add_argument("--sparse_budget", type=int, default=2048)
    p.add_argument("--rank", type=int, default=160)
    p.add_argument("--chunk_size", type=int, default=8)
    p.add_argument("--model_dir", type=str, default=None,
                   help="local HF checkpoint directory")
    p.add_argument("--bucket", type=int, default=1024,
                   help="prompt-length bucket (one prefill shape per "
                        "bucket; 0 = exact lengths)")
    p.add_argument(
        "--minference", nargs="?", const=True, default=False,
        help="sparse prefill: bare flag or 'vs' = per-head "
             "vertical_and_slash (reference --minference); 'stream' = "
             "sink+window splash prefill",
    )
    p.add_argument("--kv_quant", type=str, default="none",
                   choices=["none", "int8"],
                   help="int8: quantized V/U/landmark stores (the "
                        "bench's default regime — eval it here)")
    p.add_argument("--approx_topk", type=int, default=None,
                   choices=[0, 1],
                   help="1 = JAX's approx_max_k, which is exact off the "
                        "TPU: the port's top-k is exact with 0 and 1")
    p.add_argument("--stream_sink", type=int, default=None)
    p.add_argument("--stream_window", type=int, default=None,
                   help="stream-prefill geometry; set both < datalen "
                        "for genuinely sparse stream at short contexts")
    p.add_argument("--resume", action="store_true", default=False,
                   help="continue an interrupted run from its jsonl "
                        "archive instead of truncating it")
    # intra-replica mesh axes of the JAX package; the port runs on one
    # device, so a value above 1 raises (ROADMAP.md §1 'Parallelism')
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--pp", type=int, default=1)
    p.add_argument("--weight_quant", type=str, default="none",
                   choices=["none", "int8"],
                   help="int8: weight-only quantized dense path "
                        "(core/wquant.py)")
    p.add_argument("--use_pallas", type=str, default=None,
                   choices=["0", "1", "auto"],
                   help="fused refresh kernel (A) on the decode path; "
                        "'auto' switches on the measured hit-rate "
                        "crossover")
    p.add_argument("--hysteresis", type=float, default=0.0,
                   help="selection hysteresis (RuntimeConfig."
                        "selection_hysteresis): relative score bonus "
                        "for resident chunks; 0 = reference-exact")
    p.add_argument("--track_hit_rate", action="store_true",
                   default=False,
                   help="sample the decode slot hit rate; the final "
                        "kv_stats report includes hit_rate_mean")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cpu' runs every kernel's plain version")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from shadowkv_tpu_torch.eval.evaluator import (
        Evaluator,
        close_dist,
        init_dist,
    )

    dist = init_dist()
    dist.model_ranks = args.dp * args.tp * args.sp * args.pp
    if dist.world_size % dist.model_ranks:
        raise ValueError(f"world size {dist.world_size} is not a multiple "
                         f"of dp*tp*sp*pp = {dist.model_ranks}")
    try:
        _evaluate(args, dist, Evaluator(dist))
    finally:
        close_dist(dist)


def _evaluate(args, dist, evaluator):
    """Build the LLM, evaluate every dataset and print the summary."""
    from shadowkv_tpu_torch.data.dataset import Dataset
    from shadowkv_tpu_torch.models.llm import LLM

    mesh = None
    if dist.model_ranks > 1:
        # this replica's ranks (the evaluator's data parallelism over
        # replicas stays)
        from shadowkv_tpu_torch.parallel import mesh as mesh_lib

        mesh = (mesh_lib.build_mesh_pp(args.pp, args.tp, args.dp)
                if args.pp > 1
                else mesh_lib.build_mesh(args.dp, args.tp, args.sp))
    llm = LLM(
        model_name=args.model_name,
        batch_size=args.batch_size,
        max_length=args.datalen + 2048,
        attn_mode=args.method,
        sparse_budget=args.sparse_budget,
        rank=args.rank,
        chunk_size=args.chunk_size,
        model_dir=args.model_dir,
        minference=args.minference,
        dp=args.dp, tp=args.tp, sp=args.sp, pp=args.pp,
        weight_quant=args.weight_quant,
        track_hit_rate=args.track_hit_rate,
        selection_hysteresis=args.hysteresis,
        kv_quant=args.kv_quant,
        approx_topk=(
            None if args.approx_topk is None else bool(args.approx_topk)
        ),
        stream_sink=args.stream_sink,
        stream_window=args.stream_window,
        use_pallas=(
            None if args.use_pallas is None
            else {"0": False, "1": True, "auto": "auto"}[args.use_pallas]
        ),
        device=args.device,
        mesh=mesh,
    )
    if dist.master_process:
        llm.print_kv_stats()

    for name in args.dataset_name:
        dataset = Dataset(
            name, llm.tokenizer, args.datalen, args.num_samples,
            dist.replica, dist.replicas, bucket=args.bucket,
        )
        variant = ""
        if args.minference:
            variant += f"_{'vs' if args.minference is True else args.minference}"
        if args.kv_quant != "none":
            variant += f"_{args.kv_quant}"
        if args.approx_topk is not None:
            variant += f"_topk{args.approx_topk}"
        out = (
            f"archive/{args.model_name.split('/')[-1]}/"
            f"{name}_{args.datalen}_{args.method}_{args.sparse_budget}_"
            f"{args.rank}_{args.chunk_size}{variant}.jsonl"
        )
        evaluator.test(llm, dataset, out, args.method, resume=args.resume)

    # args.use_pallas is a string flag: "0" disables the kernel, so it
    # must not count as truthy for the stats print.
    if dist.master_process and (
        args.track_hit_rate or args.use_pallas not in (None, "", "0")
    ):
        stats = llm.engine.kv_stats()
        print(
            f"[hit-rate] mean={stats.get('hit_rate_mean')} "
            f"ema={stats.get('hit_rate_ema')} "
            f"samples={stats.get('hit_samples')} "
            f"auto_switches={stats.get('auto_switches')} "
            f"kernel_now={llm.engine._kernel_now}"
        )
    evaluator.summarize()


if __name__ == "__main__":
    main()
