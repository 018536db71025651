"""Harvest: the digest copy's wait for the card (tpusketch/harvest/wait):
the mean `digest_wait` over the window's harvest records, in ms."""


def read(obs):
    waits = [h["digest_wait"] for h in obs.get("harvests", []) if "digest_wait" in h]
    return sum(waits) / len(waits) if waits else None
