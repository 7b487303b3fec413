"""Sites: ``width_bp`` long from their start, each with a random strand."""


def draw(feat_cfg, start, res, rng):
    return start + int(feat_cfg["width_bp"]), {
        "strand": rng.choice(["+", "-"], len(start))}
