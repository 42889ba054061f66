"""setup_s: process start to the first timed round (import, the card, the
kernel library from the checkout's build cache, weights drawn on the card,
decode state, warm-up), on the host clock."""


def read(w):
    return w.setup_s
