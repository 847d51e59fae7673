"""The work of one fast-path epoch (driver `rs`): every node's RS encode
and every node's reconstruct, over all instances, as GF(2^8) products."""
from __future__ import annotations

from . import peaks


def shapes(config: dict, traffic: dict) -> dict:
    k, p = config["data_shards"], config["parity_shards"]
    payload = traffic["txns_per_node"] * config["txn_bytes"] + config["length_prefix_bytes"]
    shard_len = -(-payload // k)
    return {"k": k, "p": p, "shard_len": shard_len,
            "cols": traffic["instances"] * config["n_nodes"] * shard_len}


def epoch(config: dict, traffic: dict) -> dict:
    """{"ops", "bytes", "bound_ms"} of one epoch: the encode [p x k] and the
    reconstruct [k x k] over B * N * L byte columns, each bounded alone."""
    s = shapes(config, traffic)
    enc = peaks.gf_matmul_ms(s["p"], s["k"], s["cols"])
    rec = peaks.gf_matmul_ms(s["k"], s["k"], s["cols"])
    ops = 2 * 64 * (s["p"] * s["k"] + s["k"] * s["k"]) * s["cols"]
    nbytes = s["cols"] * (s["k"] + s["p"]) + s["cols"] * 2 * s["k"]
    return {"ops": ops, "bytes": nbytes,
            "bound_ms": peaks.bound_ms(*enc) + peaks.bound_ms(*rec)}
