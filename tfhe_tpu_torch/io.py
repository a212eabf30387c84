"""Serialization, wire-compatible with the reference tfhe_io format.

Port of ``tfhe_tpu.io``: the hybrid format of `gpuParallel/tfhe_io.cu` /
`tfhe_generic_streams.cu`:
- parameters as TextModeProperties blocks
  (`-----BEGIN T-----\\n`, sorted `key: value` lines, `-----END T-----\\n`;
  longs "%ld", doubles "%.8lf", tfhe_generic_streams.cu:43-53)
- samples and keys as binary UID-tagged little-endian dumps
  (UIDs at tfhe_generic_streams.h:15-30)

The file-level entry points mirror the reference's export/import API, so the
`secret.key` / `cloud.key` / `cloud.data` trust split of the CPU apps
(`cpuParallel/main.cpp:26-33,66-71`, `cloud.cpp:83-88`) round-trips, and
files written by the reference or by ``tfhe_tpu`` load here and the other way
round, byte for byte. Keys are numpy on ``SecretKeySet``, so the writers work
on the host; the importers build the cloud key and the ciphertexts on
`device` (the card when None). A batch of ciphertexts crosses between host
and device once, not sample by sample. ``cv`` is a double on the wire and
float32 in memory.
"""
from __future__ import annotations

import struct
from typing import BinaryIO, Tuple

import numpy as np
import torch

from .numeric import resolve_device
from .params import TfheParams
from .core.lwe import LweCiphertext

# UIDs (ref tfhe_generic_streams.h:15-30)
LWE_SAMPLE_TYPE_UID = 42
TLWE_SAMPLE_TYPE_UID = 84
TGSW_SAMPLE_TYPE_UID = 168
LWE_KEY_TYPE_UID = 43
TLWE_KEY_TYPE_UID = 85
TGSW_KEY_TYPE_UID = 169
LWE_KEYSWITCH_KEY_TYPE_UID = 200
LWE_BOOTSTRAPPING_KEY_TYPE_UID = 201


# ------------------------------------------------------------- text blocks

def _expect(got, want, what: str) -> None:
    """A file that is not in the format raises; it is input from outside."""
    if got != want:
        raise ValueError(f"{what}: want {want!r}, found {got!r}")


def _write_props(f: BinaryIO, title: str, props: dict) -> None:
    f.write(f"-----BEGIN {title}-----\n".encode())
    for k in sorted(props):  # std::map iterates keys sorted
        v = props[k]
        if isinstance(v, float):
            v = f"{v:.8f}"
        f.write(f"{k}: {v}\n".encode())
    f.write(f"-----END {title}-----\n".encode())


def _read_props(f: BinaryIO) -> Tuple[str, dict]:
    title = None
    props = {}
    while True:
        line = _read_line(f)
        if line is None:
            raise EOFError("no property block found")
        if line.startswith("-----BEGIN ") and line.endswith("-----"):
            title = line[11:-5]
            break
    end = f"-----END {title}-----"
    while True:
        line = _read_line(f)
        if line is None:
            raise EOFError("unterminated property block")
        if line == end:
            return title, props
        if ": " in line:
            k, v = line.split(": ", 1)
            props[k] = v


def _read_line(f: BinaryIO):
    out = bytearray()
    while True:
        c = f.read(1)
        if not c:
            return None if not out else out.decode()
        if c == b"\n":
            return out.decode()
        if c != b"\r":
            out += c


# ------------------------------------------------------------- param blocks

def write_lwe_params(f, n: int, alpha_min: float, alpha_max: float):
    _write_props(f, "LWEPARAMS", {"n": n, "alpha_min": float(alpha_min),
                                  "alpha_max": float(alpha_max)})


def read_lwe_params(f):
    t, p = _read_props(f)
    _expect(t, "LWEPARAMS", "property block")
    return int(p["n"]), float(p["alpha_min"]), float(p["alpha_max"])


def write_tlwe_params(f, N: int, k: int, alpha_min: float, alpha_max: float):
    _write_props(f, "TLWEPARAMS", {"N": N, "k": k, "alpha_min": float(alpha_min),
                                   "alpha_max": float(alpha_max)})


def read_tlwe_params(f):
    t, p = _read_props(f)
    _expect(t, "TLWEPARAMS", "property block")
    return int(p["N"]), int(p["k"]), float(p["alpha_min"]), float(p["alpha_max"])


def write_tgsw_params(f, params: TfheParams):
    # ref write_tGswParams (tfhe_io.cu:492-496): TLWEPARAMS section first
    write_tlwe_params(f, params.N, params.k, params.bk_stdev, params.max_stdev)
    _write_props(f, "TGSWPARAMS", {"l": params.bk_l, "Bgbit": params.bk_Bgbit})


def write_gate_bootstrapping_params(f, params: TfheParams):
    """ref write_tfheGateBootstrappingParameters (tfhe_io.cu:1031-1035)."""
    _write_props(f, "GATEBOOTSPARAMS", {"ks_t": params.ks_t, "ks_basebit": params.ks_basebit})
    write_lwe_params(f, params.n, params.ks_stdev, params.max_stdev)
    write_tgsw_params(f, params)


def read_gate_bootstrapping_params(f) -> TfheParams:
    t, p = _read_props(f)
    _expect(t, "GATEBOOTSPARAMS", "property block")
    ks_t, ks_basebit = int(p["ks_t"]), int(p["ks_basebit"])
    n, ks_stdev, max_stdev = read_lwe_params(f)
    N, k, bk_stdev, _ = read_tlwe_params(f)
    t2, p2 = _read_props(f)
    _expect(t2, "TGSWPARAMS", "property block")
    return TfheParams(n=n, N=N, k=k, bk_l=int(p2["l"]), bk_Bgbit=int(p2["Bgbit"]),
                      ks_basebit=ks_basebit, ks_t=ks_t,
                      ks_stdev=ks_stdev, bk_stdev=bk_stdev, max_stdev=max_stdev)


# ------------------------------------------------------------- binary parts

def _w_i32(f, v):
    f.write(struct.pack("<i", int(v)))


def _r_i32(f) -> int:
    raw = f.read(4)
    if len(raw) != 4:
        raise EOFError("the file ends inside a binary part")
    return struct.unpack("<i", raw)[0]


def _w_arr_i32(f, arr):
    f.write(np.ascontiguousarray(arr, dtype="<i4").tobytes())


def _r_arr_i32(f, count) -> np.ndarray:
    raw = f.read(4 * count)
    if len(raw) != 4 * count:
        raise EOFError("the file ends inside a binary part")
    return np.frombuffer(raw, dtype="<i4").astype(np.int32)


def write_lwe_sample(f, a: np.ndarray, b: int, cv: float):
    """ref write_lweSample (tfhe_io.cu:117-124): UID + a[n] + b + cv(double)."""
    _w_i32(f, LWE_SAMPLE_TYPE_UID)
    _w_arr_i32(f, a)
    _w_i32(f, b)
    f.write(struct.pack("<d", float(cv)))


def read_lwe_sample(f, n: int):
    _expect(_r_i32(f), LWE_SAMPLE_TYPE_UID, "type UID")
    a = _r_arr_i32(f, n)
    b = _r_i32(f)
    cv = struct.unpack("<d", f.read(8))[0]
    return a, np.int32(b), cv


def write_tlwe_sample(f, polys: np.ndarray, cv: float):
    """ref write_tLweSample (tfhe_io.cu:308-321): UID + (k+1) polys of N Torus32
    + cv(double). polys: int32[k+1, N]."""
    _w_i32(f, TLWE_SAMPLE_TYPE_UID)
    _w_arr_i32(f, polys)
    f.write(struct.pack("<d", float(cv)))


def read_tlwe_sample(f, k: int, N: int):
    _expect(_r_i32(f), TLWE_SAMPLE_TYPE_UID, "type UID")
    polys = _r_arr_i32(f, (k + 1) * N).reshape(k + 1, N)
    cv = struct.unpack("<d", f.read(8))[0]
    return polys, cv


def write_tgsw_sample(f, rows: np.ndarray, cv: float):
    """ref write_tGswSample (tfhe_io.cu:566-573): UID + kpl nested TLWE samples.
    rows: int32[kpl, k+1, N]; cv is written into each row's TLWE sample."""
    _w_i32(f, TGSW_SAMPLE_TYPE_UID)
    for p in range(rows.shape[0]):
        write_tlwe_sample(f, rows[p], cv)


def read_tgsw_sample(f, kpl: int, k: int, N: int):
    _expect(_r_i32(f), TGSW_SAMPLE_TYPE_UID, "type UID")
    rows = np.empty((kpl, k + 1, N), np.int32)
    cv = 0.0
    for p in range(kpl):
        rows[p], cv = read_tlwe_sample(f, k, N)
    return rows, cv


def write_tlwe_key_content(f, key: np.ndarray):
    """ref write_tLweKey_content (tfhe_io.cu:406-414): UID + k polys of N ints.
    key: int32[k, N]."""
    _w_i32(f, TLWE_KEY_TYPE_UID)
    _w_arr_i32(f, key)


def read_tlwe_key_content(f, k: int, N: int) -> np.ndarray:
    _expect(_r_i32(f), TLWE_KEY_TYPE_UID, "type UID")
    return _r_arr_i32(f, k * N).reshape(k, N)


def write_lwe_key_content(f, key: np.ndarray):
    _w_i32(f, LWE_KEY_TYPE_UID)
    _w_arr_i32(f, key)


def read_lwe_key_content(f, n: int) -> np.ndarray:
    _expect(_r_i32(f), LWE_KEY_TYPE_UID, "type UID")
    return _r_arr_i32(f, n)


def write_tgsw_key_content(f, tlwe_key: np.ndarray):
    """ref write_tGswKey_content (tfhe_io.cu:658-666): UID + k polys of N ints."""
    _w_i32(f, TGSW_KEY_TYPE_UID)
    _w_arr_i32(f, tlwe_key)


def read_tgsw_key_content(f, k: int, N: int) -> np.ndarray:
    _expect(_r_i32(f), TGSW_KEY_TYPE_UID, "type UID")
    return _r_arr_i32(f, k * N).reshape(k, N)


def write_keyswitch_key_content(f, ks_a: np.ndarray, ks_b: np.ndarray, max_cv: float):
    """ref write_LweKeySwitchKey_content (tfhe_io.cu:757-785):
    UID + max variance + for (i,j,h): a[n] + b."""
    n_ext, t, base, n = ks_a.shape
    _w_i32(f, LWE_KEYSWITCH_KEY_TYPE_UID)
    f.write(struct.pack("<d", float(max_cv)))
    inter = np.concatenate(
        [ks_a.reshape(n_ext * t * base, n),
         ks_b.reshape(n_ext * t * base, 1)], axis=1)
    _w_arr_i32(f, inter)


def read_keyswitch_key_content(f, n_ext: int, t: int, base: int, n: int):
    _expect(_r_i32(f), LWE_KEYSWITCH_KEY_TYPE_UID, "type UID")
    max_cv = struct.unpack("<d", f.read(8))[0]
    flat = _r_arr_i32(f, n_ext * t * base * (n + 1)).reshape(n_ext * t * base, n + 1)
    ks_a = flat[:, :n].reshape(n_ext, t, base, n)
    ks_b = flat[:, n].reshape(n_ext, t, base)
    return ks_a, ks_b, max_cv


def write_bootstrapping_key_content(f, bk_raw: np.ndarray, max_cv: float):
    """ref write_LweBootstrappingKey_content (tfhe_io.cu:883-906):
    UID + max variance + all (k+1) polys of each of the n*kpl TLWE rows."""
    _w_i32(f, LWE_BOOTSTRAPPING_KEY_TYPE_UID)
    f.write(struct.pack("<d", float(max_cv)))
    _w_arr_i32(f, bk_raw)


def read_bootstrapping_key_content(f, n: int, kpl: int, k: int, N: int):
    _expect(_r_i32(f), LWE_BOOTSTRAPPING_KEY_TYPE_UID, "type UID")
    max_cv = struct.unpack("<d", f.read(8))[0]
    bk = _r_arr_i32(f, n * kpl * (k + 1) * N).reshape(n, kpl, k + 1, N)
    return bk, max_cv


def _write_lwe_bootstrapping_key(f, sk, write_inout=False, write_bk=False):
    """ref write_lweBootstrappingKey (tfhe_io.cu:937-944)."""
    params: TfheParams = sk.params
    if write_inout:
        write_lwe_params(f, params.n, params.ks_stdev, params.max_stdev)
    if write_bk:
        write_tgsw_params(f, params)
    _write_props(f, "LWEKSPARAMS", {"n": params.n_extract, "t": params.ks_t,
                                    "basebit": params.ks_basebit})
    write_keyswitch_key_content(f, sk.ks_a, sk.ks_b, params.ks_stdev ** 2)
    write_bootstrapping_key_content(f, sk.bk_raw, params.bk_stdev ** 2)


# ------------------------------------------------------------- keyset files

def export_secret_keyset(f, sk) -> None:
    """ref write_tfheGateBootstrappingSecretKeySet (tfhe_io.cu:1160-1166)."""
    params: TfheParams = sk.params
    write_gate_bootstrapping_params(f, params)
    _write_lwe_bootstrapping_key(f, sk)
    write_lwe_key_content(f, sk.lwe_key)
    write_tgsw_key_content(f, sk.tlwe_key)


def export_cloud_keyset(f, sk) -> None:
    """ref write_tfheGateBootstrappingCloudKeySet (tfhe_io.cu:1099-1103)."""
    write_gate_bootstrapping_params(f, sk.params)
    _write_lwe_bootstrapping_key(f, sk)


def _read_bk_and_ks(f, params: TfheParams):
    t, p = _read_props(f)
    _expect(t, "LWEKSPARAMS", "property block")
    ks_a, ks_b, _ = read_keyswitch_key_content(
        f, int(p["n"]), int(p["t"]), 1 << int(p["basebit"]), params.n)
    bk_raw, _ = read_bootstrapping_key_content(f, params.n, params.kpl, params.k, params.N)
    return ks_a, ks_b, bk_raw


def import_secret_keyset(f, device=None):
    """Read a reference-format secret keyset file; returns a SecretKeySet
    whose cloud key is derived anew on `device` (the card when None)
    (ref new_tfheGateBootstrappingSecretKeySet_fromFile, tfhe_io.cu:1146-1158)."""
    from .core.keys import SecretKeySet, cloud_from_raw

    device = resolve_device(device)
    params = read_gate_bootstrapping_params(f)
    ks_a, ks_b, bk_raw = _read_bk_and_ks(f, params)
    lwe_key = read_lwe_key_content(f, params.n)
    tlwe_key = read_tgsw_key_content(f, params.k, params.N)
    return SecretKeySet(params=params, lwe_key=lwe_key, tlwe_key=tlwe_key,
                        bk_raw=bk_raw, ks_a=ks_a, ks_b=ks_b,
                        cloud=cloud_from_raw(params, bk_raw, ks_a, ks_b, device))


def import_cloud_keyset(f, device=None):
    """Read a reference-format cloud keyset file -> (params, CloudKey on
    `device`, the card when None)
    (ref new_tfheGateBootstrappingCloudKeySet_fromFile, tfhe_io.cu:1087-1103)."""
    from .core.keys import cloud_from_raw

    device = resolve_device(device)
    params = read_gate_bootstrapping_params(f)
    ks_a, ks_b, bk_raw = _read_bk_and_ks(f, params)
    return params, cloud_from_raw(params, bk_raw, ks_a, ks_b, device)


# ------------------------------------------------------------- ciphertexts

def _sample_dtype(n: int) -> np.dtype:
    """One LWE sample on the wire (write_lwe_sample), as a packed record."""
    return np.dtype([("uid", "<i4"), ("a", "<i4", (n,)), ("b", "<i4"), ("cv", "<f8")])


def export_ciphertexts(f, ct: LweCiphertext) -> None:
    """Write a flat batch of LWE samples, each as write_lwe_sample writes it
    (ref export_gate_bootstrapping_ciphertext_toFile). The batch comes to the
    host in one copy per field."""
    n = ct.n
    rec = np.empty(ct.b.numel(), _sample_dtype(n))
    rec["uid"] = LWE_SAMPLE_TYPE_UID
    rec["a"] = ct.a.reshape(-1, n).cpu().numpy()
    rec["b"] = ct.b.reshape(-1).cpu().numpy()
    rec["cv"] = ct.cv.reshape(-1).cpu().numpy()
    f.write(rec.tobytes())


def import_ciphertexts(f, count: int, n: int, device=None) -> LweCiphertext:
    """Read `count` LWE samples of dimension n as one flat batch on `device`
    (the card when None)."""
    device = resolve_device(device)
    dtype = _sample_dtype(n)
    raw = f.read(count * dtype.itemsize)
    if len(raw) != count * dtype.itemsize:
        raise EOFError(f"want {count} LWE samples of dimension {n}, the file holds fewer")
    rec = np.frombuffer(raw, dtype)
    if not (rec["uid"] == LWE_SAMPLE_TYPE_UID).all():
        raise ValueError("not an LWE sample: wrong type UID")
    return LweCiphertext(
        torch.from_numpy(np.ascontiguousarray(rec["a"], np.int32)).to(device),
        torch.from_numpy(np.ascontiguousarray(rec["b"], np.int32)).to(device),
        torch.from_numpy(rec["cv"].astype(np.float32)).to(device))
