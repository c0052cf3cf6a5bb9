# coding: utf-8
"""Command line entry (counterpart of `foodrec_tpu/runner.py:12-32`;
reference FoodRec/runner.py:16-28):

    python -m foodrec_tpu_torch.runner -m MODEL -d DATASET [--mg]
        [--data_path DIR/] [--epochs N] [--neg_sample_num K]

runs `quick_start`'s grid search on the card; it raises where CUDA is
absent. Flags it does not know are ignored, as the JAX package's runner
ignores them. On N cards, with `mesh_shape` set in a yaml the config reads:

    torchrun --nproc_per_node=N -m foodrec_tpu_torch.runner -m MODEL ...

(rank 0 writes the log, the checkpoints and the top-k lists).
"""

import argparse


def main(argv=None):
    """Parse `argv` (sys.argv[1:] when None), run the experiment and return
    quick_start's best (hyper_tuple, valid metrics, test metrics)."""
    from foodrec_tpu_torch.engine.quick_start import quick_start

    parser = argparse.ArgumentParser()
    parser.add_argument("--model", "-m", type=str, default="SCHGN")
    parser.add_argument("--dataset", "-d", type=str, default="Foodcom")
    parser.add_argument("--mg", action="store_true")
    parser.add_argument("--data_path", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--neg_sample_num", type=int, default=None)
    args, _ = parser.parse_known_args(argv)

    config_dict = {"gpu_id": 0}
    for k in ("data_path", "epochs", "neg_sample_num"):
        if getattr(args, k) is not None:
            config_dict[k] = getattr(args, k)
    return quick_start(model=args.model, dataset=args.dataset,
                       config_dict=config_dict, save_model=True, mg=args.mg)


if __name__ == "__main__":
    main()
