"""Pinned error-message constants of the port.

The uplink-combination and horizon/policy messages are the port's own
copy of the constants in ``repro.core.errors`` (same text, so callers
matching on them see one wording in both packages).  The rest belong to the port: the entry points'
device rule and the features that later slices of the port bring.

Messages are ``.format()`` templates; call sites format them and never
raise an inline copy of the text.
"""
from __future__ import annotations

# --- uplink-combination rules (ota.check_uplink; FLConfig re-raises) -------

ERR_UNKNOWN_UPLINK = "unknown uplink {uplink!r}; known: {modes}"

ERR_OTA_TOPK = (
    "uplink='ota' cannot apply top-k sparsification: analog "
    "superposition transmits the raw update vector over the "
    "air, never a per-device coded payload; set topk=1.0"
)

ERR_OTA_COMPRESSION = (
    "uplink='ota' requires compression='none': the PS receives "
    "the noisy analog sum and never decodes per-device "
    "payloads, so DoReFa quantization cannot apply"
)

ERR_OTA_MAPEL = (
    "uplink='ota' cannot use power_mode='mapel': MAPEL "
    "optimizes SIC decode rates, which analog superposition "
    "never performs; use power_mode='max' or 'ota-align'"
)

ERR_OTA_ALIGN_UPLINK = (
    "power_mode='ota-align' requires uplink='ota': alignment "
    "powers implement truncated channel inversion for the analog "
    "sum and have no digital-uplink meaning"
)

# --- horizon / policy coherence (FLConfig + the scanned drivers) ----------

ERR_SCAN_ONLINE_POLICY = (
    "horizon='scan' cannot drive online policy "
    "{scheduler!r}: it does not implement the traced selection "
    "protocol (scheduling.SchedulerPolicy: traced_protocol = True "
    "+ init_traced/select_round_traced), so its FL-state feedback "
    "needs the host round loop; use horizon='per-round' or add "
    "the traced protocol"
)

ERR_SCAN_ONLINE_MAPEL = (
    "horizon='scan' with online policy {scheduler!r} cannot use "
    "power_mode='mapel': the polyblock search is host-iterative "
    "and cannot run inside the traced round body; use "
    "power_mode='max' (or 'ota-align' under uplink='ota')"
)

# --- port-only rules --------------------------------------------------------

ERR_NO_CUDA = (
    "device {device!r} requested but torch.cuda.is_available() is False; "
    "pass device='cpu' to run on the CPU explicitly"
)

ERR_BAD_DEVICE = "unsupported device type {device!r}; use 'cuda' or 'cpu'"

ERR_KERNEL_BUILD = (
    "building CUDA kernel {name!r} failed: {reason}"
)

ERR_KERNEL_LAUNCH = (
    "CUDA kernel {name!r} failed to launch: {reason}"
)

# the reference's wording (repro/kernels/sic_rates.py), kept for the port
ERR_SIC_GROUP_TOO_LARGE = (
    "sic_weighted_rates_pallas supports NOMA groups of K <= {k_max} "
    "(got K={k}); use the jnp reference path for larger groups"
)
