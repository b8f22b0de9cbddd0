"""BigVGAN's discriminators: the work of one forward of the MPD and the MRD
over ``samples`` samples of a batch of ``batch``. Dots: every conv's
multiply-adds, 2 Cin Cout kh kw H_out W_out; other operations: the leaky
ReLU and the bias on every conv output, the STFT magnitude (an FFT is not
counted: it is no product of the model's weights). Bytes: the wave in, the
scores out and the float32 weights (v and g), once."""

from __future__ import annotations


def _conv(cin, cout, kh, kw, h, w, sh=1, sw=1, ph=0, pw=0):
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    return 2.0 * cin * cout * kh * kw * ho * wo, 2.0 * cout * ho * wo, \
        cout * cin * kh * kw + 2 * cout, ho, wo


def forward(periods, resolutions, samples: int, batch: int = 1) -> dict:
    dots = other = params = 0.0
    for p in periods:
        h, w, cin = -(-samples // p), p, 1
        for cout in (32, 128, 512, 1024):
            d, o, n, h, w = _conv(cin, cout, 5, 1, h, w, 3, 1, 2, 0)
            dots, other, params, cin = dots + d, other + o, params + n, cout
        for cout, k, pad in ((1024, 5, 2), (1, 3, 1)):
            d, o, n, h, w = _conv(cin, cout, k, 1, h, w, 1, 1, pad, 0)
            dots, other, params, cin = dots + d, other + o, params + n, cout
    for n_fft, hop, _ in resolutions:
        frames = 1 + (samples + (n_fft - hop) - n_fft) // hop
        h, w, cin = n_fft // 2 + 1, frames, 1
        other += 3.0 * h * w
        for k, sw, pw, cout in (((3, 9), 1, 4, 32), ((3, 9), 2, 4, 32),
                                ((3, 9), 2, 4, 32), ((3, 9), 2, 4, 32),
                                ((3, 3), 1, 1, 32), ((3, 3), 1, 1, 1)):
            d, o, n, h, w = _conv(cin, cout, *k, h, w, 1, sw, 1, pw)
            dots, other, params, cin = dots + d, other + o, params + n, cout
    return {"dots": batch * dots, "other": batch * other,
            "bytes": 4.0 * (batch * samples + params)}
