"""prefix_hit.batch: prompt tokens served from the prefix cache
(`Request.prefix_tokens`) over all prompt tokens of the window's admitted
requests (program counter)."""


def read(record):
    if record.get("kind") != "serve":
        return None
    rows = [r for r in record["requests"] if r["admitted"] is not None]
    total = sum(r["prompt_len"] for r in rows)
    return 100.0 * sum(r["prefix_tokens"] for r in rows) / total \
        if total else None
