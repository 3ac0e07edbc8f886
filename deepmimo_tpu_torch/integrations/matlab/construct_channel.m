function [h, n_used] = construct_channel(pm, tx_power, fc, has_doppler, p)
% CONSTRUCT_CHANNEL  One user's channel from an exported path matrix.
%
% pm rows (exporter layout, deepmimo_tpu/integrations/matlab_export.py):
%   1 phase (deg), 2 ToA (s), 3 power (dBm), 4 DoA az, 5 DoA el,
%   6 DoD az, 7 DoD el, 8 LoS flag [, 9 doppler vel (m/s), 10 dop acc].
%
% Math identical to the deepmimo_tpu renderer / tests/oracle.py: rotated
% spherical angles, UPA response exp(j k d.(pos)), per-path OFDM gain
% amp*exp(j(psi - 2*pi*delay_n*k/Nfft)) with over-FFT paths zeroed, and
% optional Doppler phase from per-path radial velocity/acceleration.
%
% Returns h: [R x T x K] (freq domain) or [R x T x L] time-domain taps;
% with p.enable_doppler a 4th snapshot dim. n_used = paths kept.

c_light = 299792458.0;

n_used = 0;
n_rx = prod(p.ue_shape);
n_tx = prod(p.bs_shape);
n_snap = 1;
if p.enable_doppler, n_snap = numel(p.doppler_times); end
if p.freq_domain
    h = zeros(n_rx, n_tx, numel(p.selected_subcarriers), n_snap);
else
    h = zeros(n_rx, n_tx, p.num_paths, n_snap);
end

if isempty(pm), h = squeeze4(h, n_snap); return; end
np_all = size(pm, 2);
keep = 1:min(np_all, p.num_paths);
pm = pm(:, keep);

phase_deg = pm(1, :);
delay_s = pm(2, :);
power_dbw = pm(3, :) - tx_power;         % invert exporter's dBm re-reference
aoa_az = pm(4, :); aoa_el = pm(5, :);
aod_az = pm(6, :); aod_el = pm(7, :);

% Rotated spherical angles (radians) at both ends.
[aod_t, aod_p] = rotate_angles(p.bs_rotation, aod_el, aod_az);
[aoa_t, aoa_p] = rotate_angles(p.ue_rotation, aoa_el, aoa_az);

% Field-of-view masks on the rotated angles.
mask = true(1, numel(phase_deg));
if ~isempty(p.bs_fov), mask = mask & fov_mask(p.bs_fov, aod_t, aod_p); end
if ~isempty(p.ue_fov), mask = mask & fov_mask(p.ue_fov, aoa_t, aoa_p); end
if ~any(mask), h = squeeze4(h, n_snap); return; end

idx = find(mask);
n_used = numel(idx);

% Linear power with antenna pattern gains (on rotated elevations).
pw = 10.^(power_dbw(idx) / 10) ...
    .* antenna_pattern(p.bs_radiation_pattern, aod_t(idx)) ...
    .* antenna_pattern(p.ue_radiation_pattern, aoa_t(idx));
psi = deg2rad(phase_deg(idx));
dl = delay_s(idx);

% Panel responses [T x np], [R x np] and their outer product.
a_tx = array_response(p.bs_shape, p.bs_spacing, aod_t(idx), aod_p(idx));
a_rx = array_response(p.ue_shape, p.ue_spacing, aoa_t(idx), aoa_p(idx));
prod_e = reshape(a_rx, n_rx, 1, []) .* reshape(a_tx, 1, n_tx, []);

dop_v = []; dop_a = [];
if has_doppler && size(pm, 1) >= 10
    dop_v = pm(9, idx); dop_a = pm(10, idx);
end

for s = 1:n_snap
    t_snap = 0.0;
    if p.enable_doppler, t_snap = p.doppler_times(s); end
    if p.freq_domain
        nfft = p.subcarriers;
        delay_n = dl * p.bandwidth;
        over = delay_n >= nfft;
        amp = sqrt(max(pw, 0) / nfft); amp(over) = 0;
        k = p.selected_subcarriers(:)';              % 0-based bins
        gains = (amp .* exp(1j * psi)).' .* ...
            exp(-1j * 2 * pi / nfft * (delay_n.' * k));   % [np x K]
        if ~isempty(dop_v)
            t0 = dl + t_snap;
            dop = exp(-1j * 2 * pi * fc * ...
                (dop_v .* t0 / c_light + dop_a .* t0.^2 / (2 * c_light)));
            gains = gains .* dop.';
        end
        hk = zeros(n_rx, n_tx, numel(k));
        for q = 1:numel(k)
            hk(:, :, q) = sum(prod_e .* reshape(gains(:, q), 1, 1, []), 3);
        end
        h(:, :, :, s) = hk;
    else
        g = sqrt(max(pw, 0)) .* exp(1j * psi);       % [1 x np] tap gains
        if ~isempty(dop_v)
            t0 = dl + t_snap;
            g = g .* exp(-1j * 2 * pi * fc * ...
                (dop_v .* t0 / c_light + dop_a .* t0.^2 / (2 * c_light)));
        end
        ht = zeros(n_rx, n_tx, p.num_paths);
        ht(:, :, 1:n_used) = prod_e .* reshape(g, 1, 1, []);
        h(:, :, :, s) = ht;
    end
end
h = squeeze4(h, n_snap);
end

function h = squeeze4(h, n_snap)
% Drop the trailing snapshot dim when a single snapshot is rendered.
if n_snap == 1, h = h(:, :, :, 1); end
end
