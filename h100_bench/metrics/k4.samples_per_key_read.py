"""K4's samples a key read: the mean S of the samples K4 (csrc/cmux.cu
blind_rotate_kernel with the fused key switch) bootstrapped, S the samples a
block holds, which share each read of a key slice (2 in the form (2, 2) at
l = 2, the chosen form's S at l = 3). From the program's counter
``ops.cmux.FORM_SAMPLES`` (samples by launch name, l, S and key buffers),
which counts from the process's start: the warm-up sends the window's
batches, so its forms are the window's. Nothing where the program has no
such counter (a checkout before it) or launched no K4."""


def read(run):
    from tfhe_tpu_torch.ops import cmux
    forms = getattr(cmux, "FORM_SAMPLES", None)
    if not forms:
        return None
    k4 = {key: n for key, n in forms.items() if key[0] == "blind_rotate_ks_fused"}
    total = sum(k4.values())
    if total == 0:
        return None
    return sum(key[2] * n for key, n in k4.items()) / total
