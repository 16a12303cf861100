"""serve_tokens_per_s: every output token emitted by the window's end,
those of unfinished requests included, over the window's seconds (closed
loop; host clock)."""


def read(record):
    if record.get("kind") != "serve" or record.get("loop") != "closed":
        return None
    return record["tokens_emitted"] / record["window_s"]
