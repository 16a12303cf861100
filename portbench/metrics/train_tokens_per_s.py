"""train_tokens_per_s: the tokens of every optimizer step of the window
over the window's seconds, the window ending when the card has finished
them (host clock).  A traced run leaves its profiled steps out of both."""


def read(record):
    if record.get("kind") != "train" or record["window_s"] <= 0:
        return None
    return record["steps"] * record["tokens_per_step"] / record["window_s"]
