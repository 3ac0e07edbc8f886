function a = array_response(shape, spacing, theta_rad, phi_rad)
% ARRAY_RESPONSE  UPA response [N x np] for per-path angles (radians).
%
% Panel in the y-z plane, element t = n*M1 + m at position (0, m, n) in
% units of `spacing` wavelengths; phase = k d . pos with
% k = 2*pi*spacing*(sin(t)cos(p), sin(t)sin(p), cos(t)) — identical to
% deepmimo_tpu/ops/geometry.py and tests/oracle.py:oracle_array_response.

m1 = shape(1); m2 = shape(2);
kd = 2 * pi * spacing;
ky = kd * (sin(theta_rad) .* sin(phi_rad));    % [1 x np]
kz = kd * cos(theta_rad);

m = (0:m1-1)';                                 % y index (fast)
n = (0:m2-1)';                                 % z index (slow)
ph = reshape(m * ky, m1, 1, []) + reshape(n * kz, 1, m2, []);
a = reshape(exp(1j * ph), m1 * m2, []);
end
