"""host_syncs_per_step: the program's counted host syncs
(``repro_torch.device.SYNC_STATS``) per token step of the window."""


def read(w):
    steps = w.K * len(w.rounds)
    if not steps:
        return None
    return sum(r["syncs"] for r in w.rounds) / steps
