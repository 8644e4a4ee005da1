# Quartus out-of-context compile flow: virtual pins (no package pin
# assignment), timing-driven synthesis, full compile, reports collected into
# reports/. Substitution tokens resolved by rtl_model.py at write time.
#
# Capability parity with the reference flow
# (src/da4ml/codegen/rtl/common_source/build_quartus_prj.tcl of calad0i/da4ml).

set name   "@NAME@"
set device "@PART@"
set flavor "@FLAVOR@"

set root    [file normalize [file dirname [info script]]/..]
set out_dir "$root/build_$name"
set rpt_dir "$out_dir/reports"
file mkdir $out_dir
file mkdir $rpt_dir
cd $out_dir

load_package flow

project_new $name -overwrite -revision $name
set_global_assignment -name FAMILY [lindex [split $device "-"] 0]
set_global_assignment -name DEVICE $device
set_global_assignment -name TOP_LEVEL_ENTITY "${name}_wrapper"
set_global_assignment -name PROJECT_OUTPUT_DIRECTORY $out_dir

if { $flavor eq "vhdl" } {
    set_global_assignment -name VHDL_INPUT_VERSION VHDL_2008
    foreach f [glob -nocomplain "$root/src/*.vhd"] {
        set_global_assignment -name VHDL_FILE $f
    }
} else {
    foreach f [glob -nocomplain "$root/src/*.v"] {
        set_global_assignment -name VERILOG_FILE $f
    }
}
foreach f [glob -nocomplain "$root/src/*.mem"] {
    file copy -force $f "$out_dir/[file tail $f]"
}
if { [file exists "$root/constraints/$name.sdc"] } {
    file copy -force "$root/constraints/$name.sdc" "$out_dir/$name.sdc"
    set_global_assignment -name SDC_FILE "$out_dir/$name.sdc"
}

# out-of-context: run analysis & synthesis once, then pin every top-level
# port to a virtual pin so the fitter never touches the package
execute_module -tool map
foreach_in_collection pin [get_names -filter * -node_type pin] {
    set_instance_assignment -to [get_name_info -info full_path $pin] -name VIRTUAL_PIN ON
}
export_assignments

set_global_assignment -name OPTIMIZATION_MODE "HIGH PERFORMANCE EFFORT"
set_global_assignment -name OPTIMIZATION_TECHNIQUE SPEED
set_global_assignment -name AUTO_RESOURCE_SHARING ON
set_global_assignment -name ALLOW_REGISTER_RETIMING ON
set_global_assignment -name SYNTH_TIMING_DRIVEN_SYNTHESIS ON
set_global_assignment -name TIMEQUEST_MULTICORNER_ANALYSIS ON
set_global_assignment -name FITTER_EFFORT "STANDARD FIT"

execute_flow -compile

foreach f [glob -nocomplain "$out_dir/*.rpt"] {
    file copy -force $f "$rpt_dir/"
}
project_close

puts "da4ml-tpu: compile done, reports in $rpt_dir"
