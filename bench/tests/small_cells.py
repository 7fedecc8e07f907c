"""Each cell at a size a CPU test can hold: its configuration and traffic
with the widths, depth, data and clients cut down, everything else (the
kind, the FL algorithm and mode, the compression, the check's rounds) as
the cell has it."""
import copy

from bench import spec


def cell(name: str):
    """``(bench, entry, cfg, traffic)`` of cell ``name``, small."""
    bench = spec.load_benchmark()
    entry = spec.cell(bench, name)
    cfg = copy.deepcopy(spec.config(bench, entry))
    traffic = copy.deepcopy(spec.traffic(entry["traffic"]))
    if cfg["kind"] == "image_classifier":
        cfg["model"].update(channels=[8, 8, 16, 16], pool_after=[1, 3])
        traffic["data"].update(num_train=400, num_test=100)
        traffic["fl"].update(num_clients=10, clients_per_round=4, top_n=2,
                             batch_per_client=8)
    else:
        cfg["model"].update(num_layers=2, d_model=128, num_heads=4,
                             num_kv_heads=2, head_dim=32, d_ff=256,
                             vocab_size=512, ssm_head_dim=32, ssm_chunk=16)
        traffic["data"].update(seq_len=40, num_sequences=64,
                               eval_sequences=8)
    traffic["eval_every"] = 2
    return bench, entry, cfg, traffic


def cells() -> list[str]:
    return [w["name"] for w in spec.load_benchmark()["workloads"]]
