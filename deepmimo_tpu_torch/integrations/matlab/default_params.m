function p = default_params()
% DEFAULT_PARAMS  Generation parameters for DeepMIMO_TPU_generate.
%
% Mirrors deepmimo_tpu.ChannelGenParameters defaults
% (deepmimo_tpu/generator/params.py).

p.bs_shape = [8, 1];            % BS UPA [horizontal, vertical]
p.bs_spacing = 0.5;             % element spacing (wavelengths)
p.bs_rotation = [0, 0, 0];      % degrees
p.bs_radiation_pattern = 'isotropic';
p.bs_fov = [];                  % [az el] degrees; empty = full sphere

p.ue_shape = [1, 1];
p.ue_spacing = 0.5;
p.ue_rotation = [0, 0, 0];
p.ue_radiation_pattern = 'isotropic';
p.ue_fov = [];

p.freq_domain = true;           % false = time-domain taps
p.subcarriers = 512;            % OFDM FFT size
p.selected_subcarriers = 0:31;  % 0-based subcarrier bins
p.bandwidth = 10e6;             % Hz
p.num_paths = 25;               % max paths kept per user

p.enable_doppler = false;       % needs doppler rows in the export
p.doppler_times = 0.0;          % snapshot times (s)
end
