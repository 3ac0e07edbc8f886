function g = antenna_pattern(name, theta_rad)
% ANTENNA_PATTERN  Power gain of the element pattern at elevation theta.
%
% 'isotropic' or 'halfwave-dipole' (1.643 * cos(pi/2 cos t)^2 / sin t),
% matching deepmimo_tpu/ops/patterns.py / tests/oracle.py:oracle_pattern.

switch name
    case 'isotropic'
        g = ones(size(theta_rad));
    case 'halfwave-dipole'
        sin_t = sin(theta_rad);
        g = zeros(size(theta_rad));
        ok = abs(sin_t) > 1e-10;
        g(ok) = 1.643 * cos(pi / 2 * cos(theta_rad(ok))).^2 ./ sin_t(ok);
    otherwise
        error('antenna_pattern:unknown', 'unknown pattern %s', name);
end
end
