"""Four mini-games matching the reward-TIMING structure of the paper's Atari
games (port of ``repro/rl/envs/minigames.py``; the ROMs are not used):

  * MiniPong   (Pong):      sparse +/-1 on point scored, short delay
  * Duel       (Boxing):    dense immediate rewards for landing hits
  * Shooter    (Centipede): DELAYED rewards (projectile travel time)
  * PillMaze   (Ms-Pacman): dense pill rewards + terminal ghost risk

Batched over a leading env axis, with the random draws as inputs
(``envs/base.py``). The arithmetic is the reference's, op for op in f32, so
the same draws give the same states: rounding is ``torch.round`` (half to
even, as ``jnp.round``; Pong's ball sits on multiples of 0.5), an image
cell painted twice keeps the larger value (a scatter-max, as ``.at[].max``),
and PillMaze paints its ghost over its agent (``.set`` in order).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.rl.envs.base import Env, EnvSpec, lead

G = 16  # default grid


def _rand(gen, *shape):
    return torch.rand(shape, generator=gen, device=gen.device)


def _randint(gen, lo, hi, shape):
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device)


def _cell(v):
    """The reference's ``clip(round(v).astype(int32), 0, G - 1)``."""
    return torch.round(v).long().clamp_(0, G - 1)


class _Games(Env):
    """Shared device-side tables and the image painter."""

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._bases = {}

    def _base(self, n):
        """(n, 1) offsets of each env's image in a flat batch of images."""
        if n not in self._bases:
            self._bases[n] = torch.arange(n, device=self.device)[:, None] * (G * G)
        return self._bases[n]

    def _const(self, values, dtype=torch.float32):
        return torch.tensor(values, dtype=dtype, device=self.device)

    def _paint(self, ys, xs, vs):
        """(n, P) positions and values -> (n, G, G) images: each cell the
        largest value painted on it, 0 elsewhere."""
        n = ys.shape[0]
        idx = self._base(n) + _cell(ys) * G + _cell(xs)
        img = torch.zeros(n * G * G, device=self.device)
        img.scatter_reduce_(0, idx.reshape(-1), vs.expand(idx.shape).reshape(-1), "amax")
        return img.view(n, G, G)


# ===========================================================================
# MiniPong
# ===========================================================================
class PongState(NamedTuple):
    ball: torch.Tensor      # (n, 4): y, x, vy, vx
    pad: torch.Tensor       # agent paddle y (right edge)
    opp: torch.Tensor       # opponent paddle y (left edge)
    t: torch.Tensor         # int32
    score: torch.Tensor     # running agent score (for the episode metric)


class PongResetDraws(NamedTuple):
    vy: torch.Tensor        # index into (-1, -0.5, 0.5, 1)
    vx: torch.Tensor        # index into (-1, 1)


class NoDraws(NamedTuple):
    pass


class MiniPong(_Games):
    spec = EnvSpec("pong", 3, G, 256)

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._vy = self._const([-1.0, -0.5, 0.5, 1.0])
        self._vx = self._const([-1.0, 1.0])
        self._move = self._const([0.0, -1.0, 1.0])          # stay, up, down
        self._side = self._const([-1.0, 0.0, 1.0])          # a paddle's 3 cells
        self._xs = self._const([G - 1.0] * 3 + [0.0] * 3)
        self._vs = self._const([1.0] + [0.8] * 3 + [0.6] * 3)

    def reset_draws(self, gen, n):
        return PongResetDraws(_randint(gen, 0, 4, lead(n)), _randint(gen, 0, 2, lead(n)))

    def step_draws(self, gen, n):
        return NoDraws()

    def reset(self, d: PongResetDraws):
        n = d.vy.shape[0]
        mid = torch.full((n,), G / 2, device=self.device)
        st = PongState(torch.stack([mid, mid, self._vy[d.vy], self._vx[d.vx]], -1), mid, mid,
                       torch.zeros(n, dtype=torch.int32, device=self.device),
                       torch.zeros(n, device=self.device))
        return st, self._obs(st)

    def _obs(self, s: PongState):
        ys = torch.cat([s.ball[:, :1], s.pad[:, None] + self._side,
                        s.opp[:, None] + self._side], 1)
        xs = torch.cat([s.ball[:, 1:2], self._xs.expand(len(ys), 6)], 1)
        return self._paint(ys, xs, self._vs)

    def step(self, s: PongState, action, d=None):
        pad = torch.clamp(s.pad + self._move[action], 1, G - 2)
        # scripted opponent tracks the ball with capped speed (imperfect)
        y, x, vy, vx = s.ball.unbind(-1)
        opp = torch.clamp(s.opp + torch.clamp(y - s.opp, -0.55, 0.55), 1, G - 2)
        y2, x2 = y + vy, x + vx
        vy = torch.where((y2 < 0) | (y2 > G - 1), -vy, vy)
        y2 = torch.clamp(y2, 0, G - 1)
        # paddle bounces
        hit_agent = (x2 >= G - 2) & ((y2 - pad).abs() <= 1.7) & (vx > 0)
        hit_opp = (x2 <= 1) & ((y2 - opp).abs() <= 1.7) & (vx < 0)
        vx = torch.where(hit_agent | hit_opp, -vx, vx)
        x2 = torch.clamp(x2, 0, G - 1)
        # scoring (the two cannot both happen)
        agent_scores = (x2 <= 0) & ~hit_opp
        opp_scores = (x2 >= G - 1) & ~hit_agent
        reward = agent_scores.float() - opp_scores.float()
        point = agent_scores | opp_scores
        yn = torch.where(point, G / 2, y2)
        xn = torch.where(point, G / 2, x2)
        vxn = torch.where(point, torch.where(agent_scores, 1.0, -1.0), vx)
        t = s.t + 1
        st = PongState(torch.stack([yn, xn, vy, vxn], -1), pad, opp, t, s.score + reward)
        done = (t >= self.spec.max_steps) | (st.score.abs() >= 3)
        return st, self._obs(st), reward, done


# ===========================================================================
# Duel (Boxing analogue: immediate dense rewards)
# ===========================================================================
class DuelState(NamedTuple):
    me: torch.Tensor        # (n, 2) y, x
    foe: torch.Tensor
    t: torch.Tensor
    score: torch.Tensor


class DuelResetDraws(NamedTuple):
    me: torch.Tensor        # (n, 2) uniform [0, 1)
    foe: torch.Tensor


class DuelStepDraws(NamedTuple):
    jitter: torch.Tensor    # (n, 2) uniform [-0.5, 0.5): the foe's random step
    punch: torch.Tensor     # (n,) uniform [0, 1): the foe punches below 0.25


class Duel(_Games):
    spec = EnvSpec("boxing", 6, G, 200)  # 4 moves + stay + punch

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._moves = self._const([[0, 0], [-1, 0], [1, 0], [0, -1], [0, 1], [0, 0]])
        self._vs = self._const([1.0, 0.5])

    def reset_draws(self, gen, n):
        return DuelResetDraws(_rand(gen, *lead(n), 2), _rand(gen, *lead(n), 2))

    def step_draws(self, gen, n):
        return DuelStepDraws(_rand(gen, *lead(n), 2) - 0.5, _rand(gen, *lead(n)))

    def reset(self, d: DuelResetDraws):
        n = d.me.shape[0]
        st = DuelState(4.0 + d.me * (G - 8), 4.0 + d.foe * (G - 8),
                       torch.zeros(n, dtype=torch.int32, device=self.device),
                       torch.zeros(n, device=self.device))
        return st, self._obs(st)

    def _obs(self, s: DuelState):
        pos = torch.stack([s.me, s.foe], 1)
        return self._paint(pos[..., 0], pos[..., 1], self._vs)

    def step(self, s: DuelState, action, d: DuelStepDraws):
        me = torch.clamp(s.me + self._moves[action], 1, G - 2)
        # scripted foe: approach + random jitter, punches when adjacent
        stepv = torch.clamp(me - s.foe, -1, 1) + d.jitter
        foe = torch.clamp(s.foe + stepv, 1, G - 2)
        near = (me - foe).abs().sum(-1) <= 2.0
        i_punch = (action == 5) & near
        foe_punch = (d.punch < 0.25) & near
        reward = i_punch.float() - foe_punch.float()
        t = s.t + 1
        st = DuelState(me, foe, t, s.score + reward)
        done = t >= self.spec.max_steps
        return st, self._obs(st), reward, done


# ===========================================================================
# Shooter (Centipede analogue: DELAYED rewards — bullet flight time)
# ===========================================================================
class ShooterState(NamedTuple):
    gun_x: torch.Tensor
    bullets: torch.Tensor       # (n, 4, 2) y, x; y < 0 = inactive
    targets: torch.Tensor       # (n, G) presence per column at row target_row
    target_row: torch.Tensor
    t: torch.Tensor
    score: torch.Tensor


class ShooterResetDraws(NamedTuple):
    u: torch.Tensor             # (n, G) uniform: a target where below 0.5


class ShooterStepDraws(NamedTuple):
    refill: torch.Tensor        # (n, G) uniform: the new row once one is cleared


class Shooter(_Games):
    spec = EnvSpec("centipede", 4, G, 256)  # stay, left, right, fire

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._move = self._const([0.0, -1.0, 1.0, 0.0])
        self._cols = torch.arange(G, dtype=torch.float32, device=self.device)
        self._slots = torch.arange(4, device=self.device)
        self._bottom = self._const([G - 1.0])

    def reset_draws(self, gen, n):
        return ShooterResetDraws(_rand(gen, *lead(n), G))

    def step_draws(self, gen, n):
        return ShooterStepDraws(_rand(gen, *lead(n), G))

    def reset(self, d: ShooterResetDraws):
        n = d.u.shape[0]
        st = ShooterState(torch.full((n,), float(G // 2), device=self.device),
                          -torch.ones((n, 4, 2), device=self.device),
                          (d.u < 0.5).float(), torch.ones(n, device=self.device),
                          torch.zeros(n, dtype=torch.int32, device=self.device),
                          torch.zeros(n, device=self.device))
        return st, self._obs(st)

    def _obs(self, s: ShooterState):
        n = s.t.shape[0]
        by, bx = s.bullets.unbind(-1)
        ys = torch.cat([s.target_row[:, None].expand(n, G), self._bottom.expand(n, 1), by], 1)
        xs = torch.cat([self._cols.expand(n, G), s.gun_x[:, None], bx], 1)
        vs = torch.cat([s.targets * 0.7, torch.ones((n, 1), device=self.device),
                        torch.where(by >= 0, 0.4, 0.0)], 1)
        return self._paint(ys, xs, vs)

    def step(self, s: ShooterState, action, d: ShooterStepDraws):
        gun = torch.clamp(s.gun_x + self._move[action], 0, G - 1)
        by, bx = s.bullets.unbind(-1)
        by = by + torch.where(by >= 0, -1.0, 0.0)            # fly upward
        # fire: activate the first inactive slot (reward arrives ~G steps later)
        inactive = by < 0
        slot = torch.argmax(inactive.to(torch.uint8), -1)    # CUDA argmax takes no bool
        fire = (action == 3) & inactive.any(-1)
        sel = fire[:, None] & (self._slots == slot[:, None])
        by = torch.where(sel, G - 2.0, by)
        bx = torch.where(sel, gun[:, None], bx)
        # hits: bullet reaches target row at a column with a target
        col = _cell(bx)
        at_row = (by >= 0) & (by <= s.target_row[:, None] + 0.5)
        hit = at_row & (s.targets.gather(1, col) > 0)
        reward = hit.sum(-1).float()
        targets = torch.clamp(s.targets.scatter_add(1, col, -hit.float()), 0, 1)
        by = torch.where(at_row, -1.0, by)
        # respawn a full row when cleared
        cleared = targets.sum(-1) < 0.5
        targets = torch.where(cleared[:, None], (d.refill < 0.5).float(), targets)
        t = s.t + 1
        st = ShooterState(gun, torch.stack([by, bx], -1), targets, s.target_row, t,
                          s.score + reward)
        done = t >= self.spec.max_steps
        return st, self._obs(st), reward, done


# ===========================================================================
# PillMaze (Ms-Pacman analogue)
# ===========================================================================
class MazeState(NamedTuple):
    me: torch.Tensor        # (n, 2) int64
    ghost: torch.Tensor     # (n, 2) int64
    pills: torch.Tensor     # (n, G, G) 0/1
    t: torch.Tensor
    score: torch.Tensor


class MazeResetDraws(NamedTuple):
    u: torch.Tensor         # (n, G, G) uniform: a pill where below 0.25


class MazeStepDraws(NamedTuple):
    move: torch.Tensor      # (n,) int in [1, 5): the ghost's random move
    u: torch.Tensor         # (n,) uniform: the ghost chases below 0.5


class PillMaze(_Games):
    spec = EnvSpec("pacman", 5, G, 256)

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._moves = self._const([[0, 0], [-1, 0], [1, 0], [0, -1], [0, 1]], torch.long)
        self._start = self._const([[G - 1, 0], [0, G - 1]], torch.long)

    def reset_draws(self, gen, n):
        return MazeResetDraws(_rand(gen, *lead(n), G, G))

    def step_draws(self, gen, n):
        return MazeStepDraws(_randint(gen, 1, 5, lead(n)), _rand(gen, *lead(n)))

    def reset(self, d: MazeResetDraws):
        n = d.u.shape[0]
        pills = (d.u < 0.25).float()
        pills[:, 0, 0] = 0.0
        pills[:, G - 1, G - 1] = 0.0
        st = MazeState(self._start[0].expand(n, 2), self._start[1].expand(n, 2), pills,
                       torch.zeros(n, dtype=torch.int32, device=self.device),
                       torch.zeros(n, device=self.device))
        return st, self._obs(st)

    @staticmethod
    def _flat(pos):
        return pos[:, :1] * G + pos[:, 1:]

    def _obs(self, s: MazeState):
        img = (s.pills * 0.3).view(len(s.pills), G * G)
        img = img.scatter(1, self._flat(s.me), 1.0).scatter(1, self._flat(s.ghost), 0.6)
        return img.view(-1, G, G)

    def step(self, s: MazeState, action, d: MazeStepDraws):
        me = torch.clamp(s.me + self._moves[action], 0, G - 1)
        # ghost: chase with prob .5, random otherwise
        chase = torch.sign(me - s.ghost)
        gmove = torch.where((d.u < 0.5)[:, None], chase, self._moves[d.move])
        ghost = torch.clamp(s.ghost + gmove, 0, G - 1)
        flat = s.pills.view(len(s.pills), G * G)
        ate = flat.gather(1, self._flat(me))[:, 0] > 0
        reward = ate.float()
        pills = flat.scatter(1, self._flat(me), 0.0).view(-1, G, G)
        caught = (me == ghost).all(-1)
        t = s.t + 1
        st = MazeState(me, ghost, pills, t, s.score + reward)
        done = caught | (t >= self.spec.max_steps) | (pills.sum((1, 2)) < 0.5)
        return st, self._obs(st), reward, done


GAMES = {"pong": MiniPong, "boxing": Duel, "centipede": Shooter,
         "pacman": PillMaze}


def make_env(name: str, device="cuda") -> Env:
    return GAMES[name](device)
