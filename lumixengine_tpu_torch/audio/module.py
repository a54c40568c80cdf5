"""Audio module (≙ reference src/audio: Clip resources, AudioDevice backends
(DirectSound/ALSA), AmbientSound + Listener + EchoZone/ChorusZone components,
per-frame 3D positioning — audio_module.h, audio_device.cpp).

TPU re-architecture: the ENGINE side of audio — per-frame 3D gain/pan
computation for every playing sound (distance attenuation vs the listener,
zone effects) — is a batched device pass inside the fused step. Actual sample
mixing is a separate batched kernel (`mix_block`) producing interleaved stereo
float blocks from the baked clip bank: useful for offline render/headless
sims; a platform output device (the DSound/ALSA analog) would just consume
those blocks.

The port's counterpart of ``lumixengine_tpu/audio/module.py``: the positioning
pass and the mix work on tensors with an optional leading world axis; clips,
stores and the headless device are the same host code.
"""
from __future__ import annotations

from typing import Dict, List

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from lumixengine_tpu_torch.engine.plugin import IModule, ISystem
from lumixengine_tpu_torch.engine.world import World, WorldState
from lumixengine_tpu_torch.utils.store import DenseStore


@dataclass
class AudioState:
    playing: torch.Tensor    # bool [S]
    cursor: torch.Tensor     # f32 [S] playback position (samples)
    gain: torch.Tensor       # f32 [S] computed 3D gain
    pan: torch.Tensor        # f32 [S] -1..1
    echo_mix: torch.Tensor    # f32 [] listener echo-zone wetness
    echo_delay: torch.Tensor  # f32 [] echo delay (samples)
    chorus_mix: torch.Tensor  # f32 [] listener chorus-zone wetness
    chorus_delay: torch.Tensor  # f32 [] chorus base delay (samples)
    counters: Dict[str, torch.Tensor]

    def replace(self, **kw) -> "AudioState":
        return dataclasses.replace(self, **kw)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class AudioClip:
    """PCM clip resource (mono f32; ≙ audio Clip). Procedural or WAV-loaded."""

    def __init__(self, name: str, samples: np.ndarray, rate: int = 44100, looping: bool = True):
        self.name = name
        self.samples = np.asarray(samples, np.float32)
        self.rate = rate
        self.looping = looping

    @staticmethod
    def sine(name: str, freq: float = 440.0, seconds: float = 1.0, rate: int = 22050):
        t = np.arange(int(seconds * rate)) / rate
        return AudioClip(name, 0.5 * np.sin(2 * np.pi * freq * t).astype(np.float32), rate)

    @staticmethod
    def from_wav(name: str, blob: bytes):
        import io
        import wave

        with wave.open(io.BytesIO(blob)) as w:
            n = w.getnframes()
            raw = np.frombuffer(w.readframes(n), dtype=np.int16).astype(np.float32) / 32768.0
            if w.getnchannels() == 2:
                raw = raw.reshape(-1, 2).mean(axis=1)
            return AudioClip(name, raw, w.getframerate())


class AudioModule(IModule):
    name = "audio"
    COMPONENT_STORES = {"ambient_sound": "sounds", "echo_zone": "echo_zones",
                        "chorus_zone": "chorus_zones"}

    def __init__(self, world: World, system: "AudioSystem", max_sounds: int = 64):
        super().__init__(world, system)
        self.sounds = DenseStore(
            max_sounds,
            {"clip": ((), np.int32, -1), "volume": ((), np.float32, 1.0),
             "is_3d": ((), np.bool_, True), "range": ((), np.float32, 20.0),
             "autoplay": ((), np.bool_, True)},
        )
        self.echo_zones = DenseStore(
            16, {"radius": ((), np.float32, 10.0), "wetness": ((), np.float32, 0.5),
                 "delay_ms": ((), np.float32, 120.0)}
        )
        # ≙ audio_module.h ChorusZone {delay, wetness, …}: a modulated-delay
        # tap applied while the listener is inside the zone
        self.chorus_zones = DenseStore(
            16, {"radius": ((), np.float32, 10.0), "wetness": ((), np.float32, 0.25),
                 "delay_ms": ((), np.float32, 20.0)}
        )
        self.listener_entity = -1
        self._statics = None
        self._statics_version = -1

    def component_types(self):
        return ["ambient_sound", "listener", "echo_zone", "chorus_zone"]

    def create_component(self, entity: int, ctype: str, **props):
        self._statics = None
        if ctype == "ambient_sound":
            clip = props.get("clip", -1)
            if isinstance(clip, str):
                clip = self.system.clip_id(clip)
            self.sounds.add(entity, clip=np.int32(clip),
                            volume=np.float32(props.get("volume", 1.0)),
                            is_3d=np.bool_(props.get("is_3d", True)),
                            range=np.float32(props.get("range", 20.0)),
                            autoplay=np.bool_(props.get("autoplay", True)))
        elif ctype == "listener":
            self.listener_entity = entity
        elif ctype == "echo_zone":
            self.echo_zones.add(entity, radius=np.float32(props.get("radius", 10.0)),
                                wetness=np.float32(props.get("wetness", 0.5)),
                                delay_ms=np.float32(props.get("delay_ms", 120.0)))
        elif ctype == "chorus_zone":
            self.chorus_zones.add(entity, radius=np.float32(props.get("radius", 10.0)),
                                  wetness=np.float32(props.get("wetness", 0.25)),
                                  delay_ms=np.float32(props.get("delay_ms", 20.0)))
        else:
            raise KeyError(ctype)

    def destroy_component(self, entity: int, ctype: str) -> None:
        self._statics = None
        if ctype == "ambient_sound":
            self.sounds.remove(entity)
        elif ctype == "listener":
            self.listener_entity = -1
        elif ctype == "echo_zone":
            self.echo_zones.remove(entity)
        elif ctype == "chorus_zone":
            self.chorus_zones.remove(entity)

    def prepare_statics(self, device=None):
        self.world._refresh_levels()
        if self._statics is None or self._statics_version != self.world.topology_version:
            self._statics = {
                "sound_slots": self.world.to_slots(self.sounds.entity),
                "mask": self.sounds.entity >= 0,
                "volume": np.asarray(self.sounds.data["volume"], np.float32),
                "is_3d": np.asarray(self.sounds.data["is_3d"], bool),
                "range": np.asarray(self.sounds.data["range"], np.float32),
                "clip": np.asarray(self.sounds.data["clip"], np.int32),
                "listener_slot": (self.world.slot(self.listener_entity)
                                  if self.listener_entity >= 0 else -1),
                "echo_slots": self.world.to_slots(self.echo_zones.entity),
                "echo_mask": self.echo_zones.entity >= 0,
                "echo_radius": np.asarray(self.echo_zones.data["radius"], np.float32),
                "echo_wet": np.asarray(self.echo_zones.data["wetness"], np.float32),
                "echo_delay": np.asarray(self.echo_zones.data["delay_ms"], np.float32),
                "chorus_slots": self.world.to_slots(self.chorus_zones.entity),
                "chorus_mask": self.chorus_zones.entity >= 0,
                "chorus_radius": np.asarray(self.chorus_zones.data["radius"], np.float32),
                "chorus_wet": np.asarray(self.chorus_zones.data["wetness"], np.float32),
                "chorus_delay": np.asarray(self.chorus_zones.data["delay_ms"], np.float32),
                "device": {},
            }
            self._statics_version = self.world.topology_version
        if device is not None:
            self._device_statics(torch.device(device))

    def statics(self):
        self.prepare_statics()
        return self._statics

    def _device_statics(self, device) -> dict:
        """The statics (and the clip rates) as tensors on `device`."""
        st = self._statics
        key = str(device)
        if key not in st["device"]:
            def t(a, dtype=None):
                return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

            d = {"right": t(np.asarray([1.0, 0.0, 0.0], np.float32)),
                 "rates": t(self.system.clip_rates()[np.maximum(st["clip"], 0)]),
                 "clip": t(np.maximum(st["clip"], 0), torch.int64)}
            for k in ("mask", "volume", "is_3d", "range"):
                d[k] = t(st[k])
            d["sound_slots"] = t(np.maximum(st["sound_slots"], 0), torch.int64)
            for z in ("echo", "chorus"):
                d[z + "_slots"] = t(np.maximum(st[z + "_slots"], 0), torch.int64)
                for k in ("mask", "radius", "wet", "delay"):
                    d[f"{z}_{k}"] = t(st[f"{z}_{k}"])
            st["device"][key] = d
        return st["device"][key]

    def device_state(self, device) -> AudioState:
        s = self.sounds.capacity
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return AudioState(
            playing=torch.as_tensor(np.asarray(self.sounds.data["autoplay"], bool)
                                    & (self.sounds.entity >= 0), device=device),
            cursor=torch.zeros(s, dtype=torch.float32, device=device),
            gain=torch.zeros(s, dtype=torch.float32, device=device),
            pan=torch.zeros(s, dtype=torch.float32, device=device),
            echo_mix=zero, echo_delay=zero.clone(), chorus_mix=zero.clone(),
            chorus_delay=zero.clone(),
            counters={"audible": torch.zeros((), dtype=torch.int32, device=device)},
        )

    # -- frame: 3D positioning (≙ audio_module.cpp update) ---------------------------

    def update(self, state: WorldState, dt) -> WorldState:
        st = self.statics()
        ms: AudioState = state.modules[self.name]
        if st["listener_slot"] < 0:
            return state
        d = self._device_statics(ms.cursor.device)
        wpos = state.world.pos
        lpos = wpos[..., :, st["listener_slot"]]
        lrot = state.world.rot[..., :, st["listener_slot"]]
        spos = wpos.index_select(-1, d["sound_slots"])
        dd = spos - lpos[..., None]
        dist = torch.sqrt(torch.clamp_min(torch.sum(dd * dd, dim=-2), 1e-9))
        # inverse-distance rolloff clamped to range
        att = torch.clamp(1.0 - dist / d["range"], 0.0, 1.0)
        gain = d["volume"] * torch.where(d["is_3d"], att, 1.0)
        gain = gain * ms.playing * d["mask"]
        # pan from listener-space x (≙ 3D positioning)
        from lumixengine_tpu_torch.core import math as lm

        right = lm.quat_rotate(lrot, d["right"])
        pan = torch.sum(dd * right[..., None], dim=-2) / dist
        pan = torch.where(d["is_3d"], torch.clamp(pan, -1.0, 1.0), 0.0)

        # effect zones: wetness/delay of the strongest zone containing the
        # listener (≙ EchoZone/ChorusZone queries in audio_module.cpp)
        def zone_mix(z):
            if not st[z + "_mask"].any():
                zero = torch.zeros(lpos.shape[:-1], dtype=torch.float32, device=lpos.device)
                return zero, zero
            zp = wpos.index_select(-1, d[z + "_slots"])
            zd = torch.sqrt(torch.clamp_min(torch.sum((zp - lpos[..., None]) ** 2, dim=-2), 1e-9))
            inside = (zd < d[z + "_radius"]) & d[z + "_mask"]
            w = torch.where(inside, d[z + "_wet"], 0.0)
            best = torch.argmax(w, dim=-1)
            sr = 44100.0 / 1000.0  # ms → samples at the mix rate
            dly = d[z + "_delay"][best] * sr
            return torch.amax(w, dim=-1), dly

        echo, echo_dly = zone_mix("echo")
        chorus, chorus_dly = zone_mix("chorus")
        # advance cursors
        cursor = ms.cursor + dt * d["rates"] * ms.playing
        ms = ms.replace(
            gain=gain, pan=pan, cursor=cursor,
            echo_mix=echo, echo_delay=echo_dly,
            chorus_mix=chorus, chorus_delay=chorus_dly,
            counters={"audible": torch.sum(gain > 1e-3, dim=-1, dtype=torch.int32)},
        )
        return state.replace(modules={**state.modules, self.name: ms})

    # -- host control (≙ AudioModule play/stop API) ---------------------------------

    def play(self, state: WorldState, entity: int) -> WorldState:
        slot = self.sounds.slot_of(entity)
        ms: AudioState = state.modules[self.name]
        playing, cursor = ms.playing.clone(), ms.cursor.clone()
        playing[..., slot] = True
        cursor[..., slot] = 0.0
        ms = ms.replace(playing=playing, cursor=cursor)
        return state.replace(modules={**state.modules, self.name: ms})

    def stop(self, state: WorldState, entity: int) -> WorldState:
        slot = self.sounds.slot_of(entity)
        ms: AudioState = state.modules[self.name]
        playing = ms.playing.clone()
        playing[..., slot] = False
        return state.replace(modules={**state.modules, self.name: ms.replace(playing=playing)})

    # -- mixing (the AudioDevice stand-in) ---------------------------------------------

    def mix_block(self, ms: AudioState, frames: int = 512) -> torch.Tensor:
        """Produce one stereo block [..., 2, frames] by sampling every playing
        clip at its cursor with its gain/pan, plus the listener's zone
        effects: echo = delayed tap at the zone's delay; chorus = LFO-
        modulated short delay tap (≙ EchoZone/ChorusZone DSP)."""
        st = self.statics()
        dev = ms.cursor.device
        d = self._device_statics(dev)
        bank, lengths = self.system.clip_bank(dev)
        clip = d["clip"]
        base = ms.cursor[..., :, None] + torch.arange(frames, device=dev)[None, :]
        ln = torch.clamp_min(lengths[clip][:, None], 1.0)                # [S, 1]
        rows = bank.index_select(0, clip)                                # [S, L]
        rows = rows.expand(base.shape[:-2] + rows.shape)

        def scalar(x):
            return x[..., None, None]

        def tap(offset):
            # f32 mod can round up to exactly ln (e.g. mod(-1e-5, n) → n);
            # clamp, as the reference does, to stay in bounds
            idx = torch.remainder(base + offset, ln).to(torch.int32)
            idx = torch.minimum(idx, ln.to(torch.int32) - 1)
            return torch.gather(rows, -1, idx.long())                    # [S, frames]

        samp = tap(0.0)
        # echo: one wet tap `delay` samples back
        samp = samp + scalar(ms.echo_mix) * tap(-scalar(torch.clamp_min(ms.echo_delay, 1.0)))
        # chorus: two detuned taps, ±30% LFO-modulated around the base delay
        lfo = torch.sin(2.0 * math.pi * 1.5 * (base / 44100.0))
        cd = scalar(torch.clamp_min(ms.chorus_delay, 1.0))
        samp = samp + 0.5 * scalar(ms.chorus_mix) * (
            tap(-cd * (1.0 + 0.3 * lfo)) + tap(-cd * (1.0 - 0.3 * lfo)))
        g = ms.gain[..., :, None]
        pan = ms.pan[..., :, None]
        left = torch.sum(samp * g * (0.5 * (1.0 - pan)), dim=-2)
        right = torch.sum(samp * g * (0.5 * (1.0 + pan)), dim=-2)
        return torch.stack([left, right], dim=-2)


class AudioDevice:
    """Playback-device consumer loop (≙ audio_device.cpp — the DSound/ALSA
    backend thread that pulls mixed blocks). Headless: a daemon thread calls
    `fill()` for successive blocks and accumulates them in a ring; `wav()`
    exports the captured stream for inspection."""

    def __init__(self, frames_per_block: int = 512, rate: int = 44100,
                 max_blocks: int = 256):
        self.frames = frames_per_block
        self.rate = rate
        self.max_blocks = max_blocks
        self.blocks: List[np.ndarray] = []
        self._thread = None
        self._stop = False

    def start(self, fill) -> None:
        """fill(frames) -> [2, frames] float block."""
        import threading

        self._stop = False

        def run():
            while not self._stop:
                blk = _host(fill(self.frames))
                self.blocks.append(blk)
                if len(self.blocks) > self.max_blocks:
                    self.blocks.pop(0)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def pump(self, fill, blocks: int = 1) -> None:
        """Synchronous drive (tests / offline render)."""
        for _ in range(blocks):
            self.blocks.append(_host(fill(self.frames)))

    def wav(self) -> bytes:
        import io
        import wave

        data = (np.concatenate(self.blocks, axis=-1).T if self.blocks
                else np.zeros((0, 2), np.float32))
        pcm = (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16)
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(self.rate)
            w.writeframes(pcm.tobytes())
        return buf.getvalue()


class AudioSystem(ISystem):
    """≙ audio_system.cpp — owns clips + the output device hookup."""

    name = "audio_system"

    def __init__(self, engine):
        super().__init__(engine)
        self.clips: List[AudioClip] = []
        self._by_name: Dict[str, int] = {}
        self._bank = {}

    def add_clip(self, clip: AudioClip) -> int:
        cid = len(self.clips)
        self.clips.append(clip)
        self._by_name[clip.name] = cid
        self._bank = {}
        return cid

    def clip_id(self, name: str) -> int:
        return self._by_name[name]

    def clip_rates(self) -> np.ndarray:
        return np.asarray([c.rate for c in self.clips] or [44100], np.float32)

    def clip_bank(self, device="cuda"):
        """(bank f32 [clips, max length] on `device`, lengths f32 [clips] there)."""
        key = str(torch.device(device))
        if key not in self._bank:
            n = max(len(self.clips), 1)
            maxlen = max([len(c.samples) for c in self.clips] or [1])
            bank = np.zeros((n, maxlen), np.float32)
            lengths = np.ones(n, np.float32)
            for i, c in enumerate(self.clips):
                bank[i, : len(c.samples)] = c.samples
                lengths[i] = len(c.samples)
            self._bank[key] = (torch.as_tensor(bank, device=device),
                               torch.as_tensor(lengths, device=device))
        return self._bank[key]

    def create_modules(self, world: World) -> AudioModule:
        caps = getattr(self.engine, "module_capacities", {})
        return AudioModule(world, self, max_sounds=caps.get("sounds", 64))
