"""The temporal-locality slots' hit rate over the traced decode steps:
chunk ids selected at both of two consecutive steps over the ids selected,
summed over every layer, row and KV head (from the cache's selected ids
snapshotted around each traced step)."""


def read(obs):
    if "depths" not in obs:
        return None
    ids = obs["ids"]  # [steps + 1, L, B, K, S]
    hits = sum(int((cur[..., :, None] == prev[..., None, :]).any(-1).sum())
               for prev, cur in zip(ids[:-1], ids[1:]))
    return hits / ids[1:].size
