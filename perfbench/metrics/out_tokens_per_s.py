"""out_tokens_per_s: tokens a closed-loop window's requests were served
(first tokens of prefills and every decode), over the window's seconds."""


def read(rec, cell):
    if rec["kind"] != "serve" or not rec["closed_loop"]:
        return None
    return rec["tokens"] / rec["window_s"]
