"""Kernels: the decode-attention kernel's share of its roofline at the
probe's shapes.  The bound is the bytes a call must move (K and V of
every slot at its length, read once; q read, the output written) over
the chip's HBM bandwidth; the time is the kernel's profiled device time
a call."""


def read(run):
    probe = run.out.get("probe")
    if not probe or run.peaks is None:
        return None
    ns, calls = probe["trace"].kernel_ns("decode_attention")
    if not calls:
        return None
    c = run.conf
    H = c["num_attention_heads"]
    D = c.get("head_dim") or c["hidden_size"] // H
    itemsize = 2 if c["torch_dtype"] in ("bfloat16", "float16") else 4
    per_call = run.flops.decode_attention_bytes(
        probe["slots"], H, c["num_key_value_heads"], D,
        [probe["context"] + 1] * probe["slots"], itemsize)
    bound_ns = per_call / run.peaks["hbm_bytes_per_s"] * 1e9
    return 100.0 * bound_ns * calls / ns
